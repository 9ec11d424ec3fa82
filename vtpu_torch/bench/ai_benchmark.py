#!/usr/bin/env python3
"""ai-benchmark on the card: ``benchmarks/ai-benchmark/run_benchmark.py``
for the port.

Runs the reference's model rows (ResNet-V2-50/152, VGG-16, DeepLab, LSTM,
and the transformer family) in inference and training mode and prints
img/s per row (samples/s for the token models)::

    python -m vtpu_torch.bench.ai_benchmark [--rows resnet50:50:inference]
        [--seconds 10] [--json]

Training is SGD (lr 1e-3, momentum 0.9, as ``optax.sgd``) on the
reference's loss: label 0, the log-softmax of the first 1000 (LSTM: 2)
logits of each sample, the running batch statistics written back after
each step.  Every row computes in bf16: the CNNs and the LSTM with f32
parameters, as the JAX models do; the transformer with bf16 parameters,
which runs the tensor-core flash kernels (the JAX script runs it in
f32).  Each step is waited for (one element of its output copied to the
host) before the next.

With ``TPU_DEVICE_MEMORY_LIMIT_0`` set (the device plugin's env ABI),
every step runs under the port's ``ShimRuntime.throttled``: HBM
accounting and core-percentage pacing.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch
import torch.nn.functional as F

from vtpu_torch.device import resolve_device
from vtpu_torch.models.layers import load_batch_stats
from vtpu_torch.models.registry import MODELS, create_model
from vtpu_torch.utils.sync import hard_sync

# (model, batch, mode): the reference's test matrix (BASELINE.md)
ROWS = [
    ("resnet50", 50, "inference"),
    ("resnet152", 10, "inference"),
    ("vgg16", 20, "inference"),
    ("deeplab", 2, "inference"),
    ("lstm", 100, "inference"),
    ("resnet50", 20, "training"),
    ("resnet152", 10, "training"),
    ("vgg16", 2, "training"),
    ("deeplab", 1, "training"),
    ("lstm", 10, "training"),
    # beyond the reference matrix: the long-context family (seq 512,
    # flash-attention + fused-LN path); samples/s semantics unchanged
    ("transformer", 8, "inference"),
    ("transformer", 4, "training"),
]


def build_step(name: str, batch: int, mode: str, *, device="cuda",
               dtype=torch.bfloat16, generator=None, **model_kw):
    """``(step, x, model)``: ``step(x)`` runs one inference forward
    (returns the logits) or one SGD step (returns the loss) on the row's
    input, ones (images) or zeros (tokens).  ``model_kw`` override the
    registry model's defaults (the CPU tests shrink the models with
    them)."""
    dev = resolve_device(device)
    if name == "vgg16":  # its first dense layer's width follows the input
        model_kw.setdefault("image", MODELS[name][1](batch)[1])
    model, shape_fn, in_dtype = create_model(
        name, device=dev, dtype=dtype, generator=generator, **model_kw)
    shape = shape_fn(batch)
    if in_dtype.is_floating_point:
        x = torch.ones(shape, dtype=in_dtype, device=dev)
    else:
        x = torch.zeros(shape, dtype=in_dtype, device=dev)
    if name == "transformer":
        def forward(inp):
            return model(inp, decode=False), {}
    else:
        forward = model

    if mode == "inference":
        @torch.no_grad()
        def step(inp):
            return forward(inp)[0]

        return step, x, model

    opt = torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9)
    nclass = 2 if name == "lstm" else 1000
    labels = torch.zeros(batch, dtype=torch.long, device=dev)
    rows = torch.arange(batch, device=dev)

    def step(inp):
        out, updates = forward(inp)
        logits = out if out.ndim == 2 else out.reshape(batch, -1)[:, :nclass]
        logp = F.log_softmax(logits[:, :nclass].float(), dim=-1)
        loss = -logp[rows, labels].mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        load_batch_stats(model, updates)
        return loss.detach()

    return step, x, model


def timed_imgs_per_s(step, x, batch: int, seconds: float, shim=None):
    """img/s over a window of ``seconds`` after one warm-up step; every
    step is waited for."""
    paced = shim.throttled(step) if shim is not None else step
    hard_sync(paced(x))
    n = 0
    t0 = time.monotonic()
    while time.monotonic() - t0 < seconds:
        hard_sync(paced(x))
        n += batch
    return n / (time.monotonic() - t0)


def parse_rows(spec: str):
    if not spec:
        return ROWS
    rows = []
    for item in spec.split(","):
        name, batch, mode = item.split(":")
        rows.append((name, int(batch), mode))
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--seconds", type=float, default=10.0, help="window per row")
    p.add_argument("--rows", default="", help="comma list, e.g. resnet50:50:inference")
    p.add_argument("--json", action="store_true", help="one JSON line per row")
    args = p.parse_args(argv)
    rows = parse_rows(args.rows)

    shim = None
    if os.environ.get("TPU_DEVICE_MEMORY_LIMIT_0"):
        from vtpu_torch.shim import ShimRuntime

        shim = ShimRuntime()
        print(f"# shim active: hbm quota {shim.limit_for(0)} B, "
              f"core limit {shim.core_limit}%", file=sys.stderr)
    dev = resolve_device("cuda")
    kind = torch.cuda.get_device_name(dev)
    print(f"# ai-benchmark on {kind}", file=sys.stderr)
    for name, batch, mode in rows:
        step, x, _ = build_step(name, batch, mode, device=dev)
        rate = timed_imgs_per_s(step, x, batch, args.seconds, shim)
        if args.json:
            print(json.dumps({"model": name, "batch": batch, "mode": mode,
                              "img_per_s": round(rate, 2),
                              "platform": "gpu", "device": kind}),
                  flush=True)
        else:
            print(f"{name:10s} {mode:9s} batch={batch:<4d} {rate:8.2f} img/s",
                  flush=True)
        del step, x
        torch.cuda.empty_cache()
    if shim is not None:
        shim.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
