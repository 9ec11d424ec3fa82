"""The CUDA driver-API interposer (``libvgpu_interpose.so``) that enforces
a tenant's device-memory and core quotas on unmodified CUDA programs, its
mock driver libraries for the CPU tests, and their build
(:mod:`vtpu_torch.native.build`)."""
