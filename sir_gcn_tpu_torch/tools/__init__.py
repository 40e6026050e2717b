"""The timing lab of the port: ``kernel_lab`` (variants of the bucket
broadcast + act + reduce and stream probes) and ``gather_dma`` (a per-row
gather and its take baselines), ports of ``tools/kernel_lab.py`` and
``tools/gather_dma.py``. Both run on the CUDA card unless ``--cpu`` is
given; with no card and no ``--cpu`` they raise.

This module holds what the two share: the device choice, the timing and
the bound of a line.
"""

from __future__ import annotations

import subprocess
import time

import torch

# H100 SXM data sheet: HBM rate and the f32 rate outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def resolve_device(cpu: bool) -> torch.device:
    """The CUDA card, or the CPU when asked for; never a silent fallback."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --cpu to run "
                           "on the CPU")
    return torch.device("cuda")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        out = f"{torch.cuda.get_device_name(0)}, power limit not read"
    return out


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call over ``iters`` warm calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternating_ms(calls: dict, iters: int, rounds: int) -> dict:
    """name -> the ms per call of each of ``rounds`` turns of ``iters`` warm
    calls (``cuda_ms``), the names taken in order and every other round in
    reverse: (a, b, b, a, ...) for two calls, so that a drift of the card
    falls on both alike."""
    names = list(calls)
    ms = {k: [] for k in names}
    for i in range(rounds):
        for k in names if i % 2 == 0 else names[::-1]:
            ms[k].append(cuda_ms(calls[k], iters))
    return ms


def verdict(kernel_ms: list, library_ms: list) -> str:
    """'win' if the kernel's slowest turn beats the library call's fastest,
    'loss' if its fastest is slower than the call's slowest, else 'tie'."""
    if max(kernel_ms) < min(library_ms):
        return "win"
    if min(kernel_ms) > max(library_ms):
        return "loss"
    return "tie"


def host_ms(fn) -> float:
    """ms of one call by the host clock (the CPU's plain versions)."""
    t0 = time.perf_counter()
    fn()
    return (time.perf_counter() - t0) * 1e3


def bound_ms(nbytes: int, flops: int) -> float:
    """The least ms the card could take: bytes at the HBM rate against
    f32 flops at the f32 rate, whichever is longer."""
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS) * 1e3


def measure(device, label, kernel, fn, nbytes, flops, rate_bytes, iters):
    """Time one line and print it: on the card its ms over ``iters`` warm
    calls, the rate of ``rate_bytes`` (the JAX tool's own formula) and the
    share of the bound; on the CPU one call by the host clock, which is
    no device time. Returns the line's record."""
    rec = dict(label=label, kernel=kernel, device=device.type,
               bound_ms=bound_ms(nbytes, flops))
    if device.type == "cuda":
        ms = cuda_ms(fn, iters)
        rec.update(ms=ms, gbps=rate_bytes / ms / 1e6,
                   share=rec["bound_ms"] / ms)
        print(f"{label:52s} {ms:8.4f} ms  ~{rec['gbps']:6.0f} GB/s  "
              f"{100 * rec['share']:5.1f}% of bound {rec['bound_ms']:.4f} ms",
              flush=True)
    else:
        rec.update(ms=host_ms(fn), gbps=None, share=None)
        print(f"{label:52s} {rec['ms']:8.3f} ms on the CPU (one call, host "
              f"clock; not a device time)", flush=True)
    return rec
