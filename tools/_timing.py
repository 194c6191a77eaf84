"""Timing helpers shared by the tools that time the port's kernels.

The card's name and power limit, random canonical field elements on the
card, milliseconds a call by CUDA events, the profiler's device
microseconds a launch, the host's microseconds to enqueue a call, and the
ptxas lines of a built kernel library.  Imported as ``tools._timing``
(each tool puts the repo's root on ``sys.path``).
"""

from __future__ import annotations

import subprocess
import time

import torch


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def rand_canonical(n: int, spec, gen: torch.Generator) -> torch.Tensor:
    """n elements below p (uniform below 2^(bits-1)), (n, 8) int32 on the card."""
    x = torch.randint(0, 1 << 32, (n, 8), generator=gen, dtype=torch.int64)
    x[:, 7] &= (1 << (spec.modulus.bit_length() - 1 - 224)) - 1
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32).cuda()


def events_ms(fn, reps: int) -> float:
    """Milliseconds a call of fn, by CUDA events over reps calls back to back."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_us(fn, reps: int) -> dict:
    """Each kernel's (or copy's) device microseconds a launch over reps
    calls of fn, by torch.profiler: {name: {"us", "launches"}}.  A warm-up
    step of two calls comes first and its records are dropped: in the
    first moments of a session the profiler misses launches or records
    them cut short.  The mean is over the launches recorded; "launches" is
    that count."""
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA],
                                schedule=sched) as prof:
        for calls in (2, reps):
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            prof.step()
    return {e.key: {"us": e.self_device_time_total / e.count, "launches": e.count}
            for e in prof.key_averages() if e.self_device_time_total > 0 and e.count}


def call_us(kernels: dict, reps: int) -> float | None:
    """Device microseconds a call from kernel_us's records over reps calls:
    each kernel's mean times the launches one call makes (those recorded
    over reps, rounded up); None if the profiler recorded no launch."""
    return sum(k["us"] * -(-k["launches"] // reps) for k in kernels.values()) \
        if kernels else None


def device_us(fn, reps: int, key: str) -> float | None:
    """The device microseconds a launch of the kernels whose names hold key
    (fn launches one), over the launches recorded; None if none was."""
    ks = [k for name, k in kernel_us(fn, reps).items() if key in name]
    count = sum(k["launches"] for k in ks)
    return sum(k["us"] * k["launches"] for k in ks) / count if count else None


def host_us(fn, reps: int) -> float:
    """The host's microseconds a call of fn, enqueued back to back."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / reps


def ptxas_lines(kernel) -> list[str]:
    """ptxas's entry, register and stack lines from a Kernel's build log."""
    log = kernel.lib_path.parent / f"{kernel.name}.log"
    return [ln.strip() for ln in log.read_text().splitlines()
            if "stack frame" in ln or "registers" in ln or "Compiling entry" in ln] \
        if log.exists() else []
