"""Benchmarks of the port: the ai-benchmark rows and the four-tenant
share run (``python -m vtpu_torch.bench.ai_benchmark``,
``python -m vtpu_torch.bench.share``)."""
