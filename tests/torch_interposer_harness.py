"""A tenant of the interposer's CPU tests: drives the driver API the way
CUDA's runtime does -- ``dlopen("libcuda.so.1")``, ``dlsym`` of
``cuGetProcAddress_v2``, every other entry point resolved through it --
so that under ``LD_PRELOAD`` of ``libvgpu_interpose.so`` each call goes
through its wrapper.  With ``LD_LIBRARY_PATH`` on the mock driver
libraries (``vtpu_torch.native.build.mock_dir()``) no card is involved.

    python torch_interposer_harness.py OP [OP ...]

Each OP is ``name:arg:...``; results are printed as one JSON list, one
entry per OP, when all have run:

  init                    cuInit, device 0, retain its primary context,
                          make it current
  alloc:MiB               cuMemAlloc (rc, and the pointer kept)
  pitch:width:height      cuMemAllocPitch
  managed:MiB             cuMemAllocManaged
  async:MiB:flags         cuMemAllocAsync resolved with flags
  create:MiB              cuMemCreate on device 0 (handle kept)
  free:i / freeasync:i    free the i-th kept pointer
  release:i               cuMemRelease of the i-th kept handle
  fill:MiB                allocate chunks until one fails: count, last rc
  meminfo                 cuMemGetInfo: free and total bytes
  launch:flags:n          resolve cuLaunchKernel with flags, launch n times
  graph:flags:n           resolve cuGraphLaunch with flags, launch n times
  sync                    cuCtxSynchronize
  resolve:name:flags      the library and the symbol the resolved pointer
                          lies in (dladdr): the interposer's wrappers
                          carry the names of the variants they call
  calls:name              the mock driver's count of calls to a variant
  waitcalls:name:n        wait (at most 60 s) until the mock driver has
                          counted n calls to a variant
  capture:0|1             the mock driver reports every stream as being
                          captured into a CUDA graph, or none
  error:launch|event:rc   from now on the mock driver fails every launch,
                          or every completed event's query, with rc (0:
                          succeed again)
  begincapture:flags      cuStreamBeginCapture (resolved with flags) on
                          the legacy stream; endcapture ends it
  sleep:seconds           pause the host
  nvmlmem:1|2             NVML's memory of card 0 (nvmlDeviceGetMemoryInfo
                          or its _v2), as nvidia-smi asks: total, free,
                          used bytes
  fork:MiB                fork; the child makes its context current and
                          allocates, the parent waits for it (the child's
                          pid and rc)
  touch:path / wait:path  a file barrier (wait gives up after 60 s)
"""

import ctypes
import json
import os
import sys
import time

CUDA_VERSION = 12040
P = ctypes.c_void_p


class DlInfo(ctypes.Structure):
    _fields_ = [("dli_fname", ctypes.c_char_p), ("dli_fbase", P),
                ("dli_sname", ctypes.c_char_p), ("dli_saddr", P)]


def main(ops):
    cuda = ctypes.CDLL("libcuda.so.1", mode=os.RTLD_NOW | os.RTLD_GLOBAL)
    gpa = cuda.cuGetProcAddress_v2  # through the process's dlsym
    gpa.argtypes = [ctypes.c_char_p, ctypes.POINTER(P), ctypes.c_int,
                    ctypes.c_uint64, P]
    gpa.restype = ctypes.c_int

    def resolve(name, flags=0):
        fn = P()
        rc = gpa(name.encode(), ctypes.byref(fn), CUDA_VERSION, flags, None)
        if rc != 0 or not fn.value:
            raise RuntimeError(f"cuGetProcAddress({name}) = {rc}")
        return fn.value

    def fn(name, *argtypes, flags=0):
        proto = ctypes.CFUNCTYPE(ctypes.c_int, *argtypes)
        return proto(resolve(name, flags))

    libc = ctypes.CDLL(None)
    libc.dladdr.argtypes = [P, ctypes.POINTER(DlInfo)]
    out, ptrs, handles = [], [], []
    u64p = ctypes.POINTER(ctypes.c_uint64)
    for op in ops:
        name, *args = op.split(":")
        res = {"op": op}
        if name == "init":
            ctx, dev = P(), ctypes.c_int()
            res["rc"] = (fn("cuInit", ctypes.c_uint)(0)
                         or fn("cuDeviceGet", ctypes.POINTER(ctypes.c_int),
                               ctypes.c_int)(ctypes.byref(dev), 0)
                         or fn("cuDevicePrimaryCtxRetain", ctypes.POINTER(P),
                               ctypes.c_int)(ctypes.byref(ctx), dev)
                         or fn("cuCtxSetCurrent", P)(ctx))
        elif name in ("alloc", "managed", "async", "fill"):
            mib = int(args[0]) << 20
            p = ctypes.c_uint64()
            if name == "async":
                call = fn("cuMemAllocAsync", u64p, ctypes.c_size_t, P,
                          flags=int(args[1]))
                go = lambda: call(ctypes.byref(p), mib, None)  # noqa: E731
            elif name == "managed":
                call = fn("cuMemAllocManaged", u64p, ctypes.c_size_t,
                          ctypes.c_uint)
                go = lambda: call(ctypes.byref(p), mib, 1)  # noqa: E731
            else:
                call = fn("cuMemAlloc", u64p, ctypes.c_size_t)
                go = lambda: call(ctypes.byref(p), mib)  # noqa: E731
            if name == "fill":
                n = 0
                while (rc := go()) == 0:
                    n += 1
                    ptrs.append(p.value)
                res.update(count=n, rc=rc)
            else:
                res["rc"] = go()
                if res["rc"] == 0:
                    ptrs.append(p.value)
        elif name == "pitch":
            p, pitch = ctypes.c_uint64(), ctypes.c_size_t()
            res["rc"] = fn("cuMemAllocPitch", u64p,
                           ctypes.POINTER(ctypes.c_size_t), ctypes.c_size_t,
                           ctypes.c_size_t, ctypes.c_uint)(
                ctypes.byref(p), ctypes.byref(pitch), int(args[0]),
                int(args[1]), 4)
            res["pitch"] = pitch.value
            if res["rc"] == 0:
                ptrs.append(p.value)
        elif name == "create":
            # CUmemAllocationProp: type 1 (pinned), location (device, 0)
            prop = (ctypes.c_int * 8)(1, 0, 1, 0, 0, 0, 0, 0)
            h = ctypes.c_uint64()
            res["rc"] = fn("cuMemCreate", u64p, ctypes.c_size_t, P,
                           ctypes.c_uint64)(ctypes.byref(h),
                                            int(args[0]) << 20,
                                            ctypes.addressof(prop), 0)
            if res["rc"] == 0:
                handles.append(h.value)
        elif name == "release":
            res["rc"] = fn("cuMemRelease", ctypes.c_uint64)(
                handles[int(args[0])])
        elif name == "free":
            res["rc"] = fn("cuMemFree", ctypes.c_uint64)(ptrs[int(args[0])])
        elif name == "freeasync":
            res["rc"] = fn("cuMemFreeAsync", ctypes.c_uint64, P)(
                ptrs[int(args[0])], None)
        elif name == "meminfo":
            free, total = ctypes.c_size_t(), ctypes.c_size_t()
            res["rc"] = fn("cuMemGetInfo", ctypes.POINTER(ctypes.c_size_t),
                           ctypes.POINTER(ctypes.c_size_t))(
                ctypes.byref(free), ctypes.byref(total))
            res.update(free=free.value, total=total.value)
        elif name in ("launch", "graph"):
            if name == "launch":
                call = fn("cuLaunchKernel", P, *[ctypes.c_uint] * 7, P, P, P,
                          flags=int(args[0]))
                go = lambda: call(None, 1, 1, 1, 1, 1, 1, 0,  # noqa: E731
                                  None, None, None)
            else:
                call = fn("cuGraphLaunch", P, P, flags=int(args[0]))
                go = lambda: call(None, None)  # noqa: E731
            res["rcs"] = sorted({go() for _ in range(int(args[1]))})
        elif name == "sync":
            res["rc"] = fn("cuCtxSynchronize")()
        elif name == "resolve":
            info = DlInfo()
            if not libc.dladdr(P(resolve(args[0], int(args[1]))),
                               ctypes.byref(info)):
                raise RuntimeError(f"dladdr of {args[0]}")
            res.update(lib=os.path.basename(info.dli_fname.decode()),
                       sym=(info.dli_sname or b"").decode())
        elif name in ("calls", "waitcalls"):
            counter = cuda.vtpu_mock_cuda_calls
            counter.argtypes, counter.restype = [ctypes.c_char_p], \
                ctypes.c_ulonglong
            deadline = time.monotonic() + 60
            while (name == "waitcalls"
                   and counter(args[0].encode()) < int(args[1])):
                if time.monotonic() > deadline:
                    raise TimeoutError(op)
                time.sleep(0.01)
            res["n"] = counter(args[0].encode())
        elif name == "capture":
            toggle = cuda.vtpu_mock_cuda_capture
            toggle.argtypes, toggle.restype = [ctypes.c_int], None
            toggle(int(args[0]))
        elif name == "error":
            inject = cuda.vtpu_mock_cuda_error
            inject.argtypes, inject.restype = [ctypes.c_char_p,
                                               ctypes.c_int], None
            inject(args[0].encode(), int(args[1]))
        elif name == "begincapture":
            res["rc"] = fn("cuStreamBeginCapture", P, ctypes.c_int,
                           flags=int(args[0]))(None, 0)
        elif name == "endcapture":
            graph = P()
            res["rc"] = fn("cuStreamEndCapture", P, ctypes.POINTER(P))(
                None, ctypes.byref(graph))
        elif name == "nvmlmem":
            nvml = ctypes.CDLL("libnvidia-ml.so.1")
            handle = P()
            if (nvml.nvmlInit_v2()
                    or nvml.nvmlDeviceGetHandleByIndex_v2(
                        0, ctypes.byref(handle))):
                raise RuntimeError("NVML init")
            if args[0] == "1":
                mem = (ctypes.c_ulonglong * 3)()
                res["rc"] = nvml.nvmlDeviceGetMemoryInfo(handle, mem)
                total, free, used = mem
            else:
                mem = (ctypes.c_ulonglong * 5)()  # version padded, 4 fields
                mem[0] = (2 << 24) | 40
                res["rc"] = nvml.nvmlDeviceGetMemoryInfo_v2(handle, mem)
                _v, total, _reserved, free, used = mem
            res.update(total=total, free=free, used=used)
        elif name == "sleep":
            time.sleep(float(args[0]))
        elif name == "fork":
            r, w = os.pipe()
            pid = os.fork()
            if pid == 0:
                p = ctypes.c_uint64()
                ctx, dev = P(), ctypes.c_int()
                rc = (fn("cuDeviceGet", ctypes.POINTER(ctypes.c_int),
                         ctypes.c_int)(ctypes.byref(dev), 0)
                      or fn("cuDevicePrimaryCtxRetain", ctypes.POINTER(P),
                            ctypes.c_int)(ctypes.byref(ctx), dev)
                      or fn("cuCtxSetCurrent", P)(ctx)
                      or fn("cuMemAlloc", u64p, ctypes.c_size_t)(
                          ctypes.byref(p), int(args[0]) << 20))
                os.write(w, str(rc).encode())
                os._exit(0)
            os.close(w)
            os.waitpid(pid, 0)
            res.update(child=pid, rc=int(os.read(r, 16)))
            os.close(r)
        elif name == "touch":
            open(args[0], "w").close()
        elif name == "wait":
            deadline = time.monotonic() + 60
            while not os.path.exists(args[0]):
                if time.monotonic() > deadline:
                    raise TimeoutError(args[0])
                time.sleep(0.01)
        else:
            raise ValueError(op)
        out.append(res)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
