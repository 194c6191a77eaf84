"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the nine CUDA sources
   from spartan2_tpu_torch/csrc/ (one nvcc per source, in parallel) and
   the host C libraries (native/keccak.c, native/ec_host.c, with cc),
   printing both build times; holds the host C curve on this machine's
   host against its Python versions: msm against msm_plain at 17 and
   2048 points, scalar_mul against scalar_mul_plain, on P-256 and
   Pallas.  Every host MSM and scalar multiplication of the proves and
   verifies below runs in C.
2. Drives SpartanSNARK: setup, prep_prove, a warm-up prove and two timed
   proves on SHA-256 over a 1 KiB preimage (P256HyraxEngine, Hyrax width
   2048, is_small=True), then verifies the proof, checks that a tampered
   public value is rejected and that the serialized proof is 94324 bytes.
   Each timed prove must make two eq-table launches: one sp2_eq_tables
   (the outer sum-check's 20 tables) and one sp2_eq_table (poly_ABC's),
   and the sum-check launches this port states: an F a round (40), kernel
   A's 19 quad rounds as 1 sp2_round_evals and 18 sp2_round_bind_evals
   (the previous bind folded in), 20 sp2_bind_dev (kernel G's 19 binds
   and the quad's last), no sp2_bind; the ZK and NN proves 2
   sp2_round_evals, m + mq - 2 sp2_round_bind_evals and 2 sp2_bind.
3. Drives SpartanZkSNARK on the same circuit, from the same synthesized
   shape (setup_from_shape): prep_prove, a warm-up prove and three timed
   proves, verify, a tampered proof rejected, the proof through serde and
   back.  For each path every kernel's launch count is set to 0 just
   before its setup and read after its verify; each kernel of the path
   must have been launched.  A count is of wrapper calls: one C entry
   call, which may launch more than one __global__ function; the counts
   are also kept per entry, so kernels A and B (entries of sumcheck.cu)
   and C (an entry of msm.cu) are counted apart.
4. Drives NeutronNovaZkSNARK at bench.py's NeutronNova shape: 16 steps
   of one SHA-256 compression (Sha256Circuit(bytes([i] * 55)), i < 16)
   and the core Sha256Circuit(bytes(55)), width 2048, is_small=True:
   setup, prep_prove, a first prove (it fills the prep cache of the
   batched Az/Bz/Cz and the small grid), a warm-up prove and three timed
   proves, verify, the proof through serde and back, a tampered step
   public value rejected, one traced and one profiled prove; its counts
   are set to 0 before its setup and read after its verify.  The traced
   ZK and NN proves print their verifier-circuit commits (vc_commit:
   calls and host ms).  Each profiled prove (steps 2-4) prints the device
   time, launches and share of the prove's device time of its SpMV, comb
   rows, kernel C / 5 (msm_rows_kernel), eq-table kernels, kernel F,
   kernel A's rounds and the bind; none may launch sum_partials_kernel.
5. Proves the cubic circuit on the card with both Spartan SNARKs, and
   the two NeutronNova test configurations, from the JAX package's
   recorded keys, prep state and seeds (tests/torch_golden/): each proof
   must equal the recorded JAX proof byte for byte.
6. The device transcript and the enqueued sum-checks (kernels T, F, G):
   (a) sp2_keccak256 on batches of 64 messages at lengths 0, 1, 135, 136,
   137, 271, 272 and 1000 against the host Keccak; (b) a DeviceTranscript
   sequence on the card against the host Transcript, with the hand-off
   both ways; (c) the outer sum-check on SHA-256 1 KiB's Az/Bz/Cz (2^20,
   peeled, zero_check) through the prove's driver against the
   host-challenge driver (kernel A, a pull and a host squeeze per round):
   coefficients, r_x, finals and transcript state equal, both timed end
   to end, the device driver's rounds run under
   torch.cuda.set_sync_debug_mode("error") (any host synchronization
   before its one pull raises); (d) the same for the inner round 0 and
   the quad rounds over 2^20; (e) the per-round Gruen prover at m = 12
   with tau_0 = 0 and tau_1 = 1 on the card against its plain version.
   Kernel F in every mode against its plain version: Gruen with
   zero_check (the peeled round 0's kernel G partials), plain and with
   fallback (tau = 0), cubic evals on kernel A's sums, quad and inner
   round 0; each timed by CUDA events and by its device time, and F's
   latency floor: its product depth times fe_mul_cc's latency plus two
   warp-wide Keccak-f[1600] permutations, both measured alone by
   tools/round_latency.py's probe (built beside the kernels).  (g) The
   enqueued outer and inner sum-checks captured whole in CUDA graphs
   (a capture fails on any host synchronization) and replayed on two
   sets of fresh inputs, equal to uncaptured runs.
7. Holds each kernel against its plain PyTorch version on the card, at the
   main paths' shapes, on inputs from a fixed seed: equality is exact
   (tolerance 0: every output is an integer mod p, a byte or a digest).
   Kernel A's round with the previous round's bind folded in against the
   plain bind-then-evaluate (sums and bound vectors): cubic at 2^20 rows
   with r from a challenge slot, the ZK cubic at K = 1 and K = 2 over a
   shared eq, the quad, the mesh's shard shapes, and at 2^12 rows with
   zeros and p - 1 among the entries and r in {0, 1, random}.
   Times kernel and plain version with CUDA events (no copies inside a
   timed region), and computes each kernel's bound from the bytes, the
   32-bit multiply-adds and the Keccak logic operations this run's data
   needs.  The comb, MSM and Hyrax-bind kernels are also held against
   their plain versions on the Pallas curve (a = 0).  The comb table
   build at the three tables a width-2048 key builds (43 windows x 2048,
   11 x 2048 against the 43-window plain table's first 11 windows, 43 x 1
   for h on the host), on P-256 and Pallas, each with its device time.
   Kernel B's sums (at num_cols 524545, and with one extra column, every
   column extra and K = 2 over edge values) and its bind, each timed
   alone, the sums also with a cold L2.  The eq table at
   2^20 and the outer plan's 20 tables in one sp2_eq_tables launch, timed
   by CUDA events and by the profiler's device time.  Kernels C and 5 at
   the paths' shapes (R x I = 43 x 2, 15 x 16, and 256 points) on P-256
   and Pallas, nbits 256 and 40, with zero scalars, q - 1, a repeated
   point, a point beside its negation and a point at infinity, against
   their plain version run on the host (the MSM's plain ladder is seconds
   there and tens of seconds as launches on the card); then kernel C's
   latency floor on P-256: 255 doublings in one thread (sp2_msm_per_lane,
   n = 1, scalar 2^255) and kernel C's own chain at one point.  Kernel 1 also runs
   on three skewed matrices whose long rows take a warp and a block
   (spmv with a prefix, spmv_combine, spmv_batched), and kernel 3 also at
   the blinds' shape (16 rows over h's one-column table) and at one
   full-width row.
   (f) The curve phase, the last four device functions' own path (no
   prove calls them): on P-256 and Pallas, with the counts set to 0
   first and read after, msm_binary at 2048 points, at 1000 (padded) and
   with no bit set; msm_points_per_lane over 2048 lanes at nbits 256
   (zero scalars, 1, q - 1, and q and q + 2, which meet the mixed
   addition's identity and doubling cases) and at nbits 64;
   scalar_mul_host_base with k in {0, 1, q - 1, random} over 2048
   points; mle_evaluate_device at m = 20 and m = 1.  Each result must
   equal its plain version on the card exactly, and the host's (the C
   curve, mle_evaluate_host on the pulled table).
8. The mesh phase (spartan2_tpu_torch/parallel/): W ranks spawned on the
   one card in a gloo group (FileStore rendezvous in a temporary
   directory), every kernel built here first.  (m1) W = 2 ranks each set
   up SpartanSNARK on SHA-256 1 KiB and NeutronNovaZkSNARK on 16 steps
   and prove them with the sum-checks sharded, from step 2's and step
   4's seeds: each proof must equal this run's single-device proof byte
   for byte and verify, and the shard kernels (G, F, A, B) must have
   been launched by the sharded prove; the precommitted witness's 256
   rows committed row-sharded must equal comb_rows.  (m2) W = 4 ranks run
   the sharded outer and inner sum-checks on SHA-256's Az/Bz/Cz: the
   coefficients, challenges, finals and state must equal the
   single-device provers'.  (m3) Kernel G's shard stride at s = 0 and
   s = W - 1 against its plain version on the card.  (m4) Kernels A and
   the comb at the shards' shapes.  The ranks synchronize every round,
   so nothing here runs under the sync debug mode.  A rank that fails
   fails the run.
9. Prints one JSON line with the kernels, then the card, then
   {"ok": true, ...} as the last line.  Any failed check raises.
"""

from __future__ import annotations

import copy
import json
import random
import subprocess
import sys
import time

import torch
from torch.autograd import DeviceType

# Published H100 SXM rates (NVIDIA data sheet; see PERF.md): HBM bandwidth,
# and 32-bit integer multiply-adds: 64 lanes per SM (half the 128 FP32
# lanes behind the 67 TFLOP/s FP32 figure) x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
# A Montgomery product on 8 x 32-bit limbs: 64 partial products for a*b
# and 64 for the reduction, each a 64-bit result (lo and hi multiply-add).
IMAD_PER_MONT_MUL = 256
# Keccak-f[1600] unrolled on 32-bit halves of its 64-bit lanes, a round:
# theta 80 (a 5-way XOR is 2 three-input LOP3 a half, 20; the 5 rotates of
# C by 1 are 2 funnel shifts each, 10; applying D is one LOP3 a half, 50),
# rho 48 (24 rotates, 2 funnel shifts each), pi 0 (renaming), chi 50 (one
# LOP3 a half), iota 2: 180 operations on the 64 integer lanes per SM,
# counted against IMAD_PER_S like a multiply-add.
KECCAK_F_OPS = 24 * 180
MONT_MULS_PER_ADD = 16  # complete Jacobian addition (csrc/comb.cu pt_add)
MONT_MULS_PER_MADD = 11  # complete mixed addition, affine second point (curve.cuh)


def dbl_muls(curve) -> int:
    """Montgomery products of one Jacobian doubling on ``curve``: 7 at
    a = 0 (dbl-2009-l), 8 at a = -3 (dbl-2001-b), 10 at any other a
    (dbl-1998-cmo-2), as csrc/curve.cuh's pt_dbl_k counts them."""
    p = curve.base.modulus
    a = curve.a % p
    return 7 if a == 0 else 8 if a == p - 3 else 10


PROOF_BYTES = 94324  # BENCH_r05.json proof_bytes (same wire format)


def det(seed: int):
    """bench.py's deterministic blind source: rng(q) -> int in [0, q)."""
    r = random.Random(seed)
    return lambda q: r.randrange(q)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, by CUDA events."""
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


def device_ms(fn, reps: int) -> float | None:
    """Device milliseconds of one call of fn() by torch.profiler over reps
    calls, after a dropped warm-up step (``tools/_timing.py``): the
    kernels' own time, without the host's enqueue (a launch of a few
    microseconds' work is paced by its Python wrapper under CUDA events).
    A profile that recorded no launch is taken once more; None where the
    second recorded none either.  fn runs reps + 2 times a profile."""
    from tools._timing import call_us, kernel_us

    us = call_us(kernel_us(fn, reps), reps)
    if us is None:
        us = call_us(kernel_us(fn, reps), reps)
    return None if us is None else us / 1e3


def once_ms(fn):
    """(result, milliseconds) of one run of fn(), by CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = fn()
    end.record()
    torch.cuda.synchronize()
    return res, start.elapsed_time(end)


def host_plain(fn, *tensors):
    """(result, host ms) of a plain version run on this machine's CPU on
    copies of the card's inputs: the MSM's plain ladder is thousands of
    small batched operations, seconds on the host and tens of seconds as
    launches on the card.  The kernel's output is held against it exactly."""
    cpu = [t.cpu() for t in tensors]
    t0 = time.perf_counter()
    res = fn(*cpu)
    return res, (time.perf_counter() - t0) * 1e3


def bound_ms(nbytes: float, mont_muls: float, int_ops: float = 0) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = (mont_muls * IMAD_PER_MONT_MUL + int_ops) / IMAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rand_field(n: int, spec, gen: torch.Generator, device) -> torch.Tensor:
    """n canonical elements below p (uniform below 2^(bits-1)), (n, 8)."""
    x = torch.randint(0, 1 << 32, (n, 8), generator=gen, dtype=torch.int64)
    top = spec.modulus.bit_length() - 1 - 224
    x[:, 7] &= (1 << top) - 1
    x = torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
    return x.to(device)


def check_golden_cubic(dev, zk: bool) -> None:
    """Prove the cubic circuit on the card from the JAX package's recorded
    keys, prep state and seeds (tests/torch_golden/); the proof must equal
    the recorded JAX proof byte for byte."""
    from spartan2_tpu_torch.provider.engines import get_engine
    from spartan2_tpu_torch.utils import serde
    from tests.torch_golden.make_golden import OUT, OUT_ZK, read_golden
    from tests.torch_helpers import CubicCircuit

    if zk:
        from spartan2_tpu_torch.snark.spartan_zk import SpartanZkSNARK as snark
        keys_from_bytes = serde.spartan_zk_keys_from_bytes
        proof_to_bytes = serde.spartan_zk_proof_to_bytes
    else:
        from spartan2_tpu_torch.snark.spartan import SpartanSNARK as snark
        keys_from_bytes = serde.spartan_keys_from_bytes
        proof_to_bytes = serde.spartan_proof_to_bytes
    golden = read_golden(OUT_ZK if zk else OUT)
    engine, circuit = get_engine("P256HyraxEngine"), CubicCircuit()
    pk, vk = keys_from_bytes(golden["keys"], engine, device=dev)
    prep = serde.spartan_prep_from_bytes(golden["prep"], engine, pk, circuit)
    proof, _ = snark.prove(pk, circuit, prep, rng=det(golden["prove_seed"]))
    name = snark.__name__
    if proof_to_bytes(proof, engine) != golden["proof"]:
        raise RuntimeError(f"{name}: cubic proof on the card differs from the JAX proof")
    if snark.verify(proof, vk) != [15]:
        raise RuntimeError(f"{name}: cubic proof on the card does not verify")
    print(f"cubic circuit on the card, {name}: proof equals the recorded JAX "
          f"proof ({len(golden['proof'])} bytes) and verifies", flush=True)


NONZK_COUNTS = ("wrapper calls on the SpartanSNARK path: setup, prep_prove, "
                "three proves, verify")


def kernel_record(name, replaces, launches, counts, ms, plain_ms, nbytes, muls,
                  source=None, int_ops=0):
    """One kernel of the JSON line; its bound from the bytes, Montgomery
    products and other 32-bit operations the function needs for this
    run's data."""
    b, by = bound_ms(nbytes, muls, int_ops)
    return {"name": name, "route": "cuda",
            "source": source or f"spartan2_tpu_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches, "counts": counts,
            "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
            "bound_by": by, "library_ms": None}


def detail_record(name, ms, plain_ms, nbytes, muls, int_ops=0):
    b, by = bound_ms(nbytes, muls, int_ops)
    return {"name": name, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
            "bound_by": by}


def same_or_raise(name, got, want, spec) -> None:
    """Kernel output ``got`` (tensor or ints) against the plain version's."""
    from spartan2_tpu_torch.field.limbs import limbs_to_ints

    if isinstance(got, list) and isinstance(want, torch.Tensor):
        same = got == limbs_to_ints(want, spec, mont=True)
    elif isinstance(got, torch.Tensor):
        same = torch.equal(got, want)
    else:
        same = got == want
    if not same:
        raise RuntimeError(f"{name}: kernel differs from its plain version")
    print(f"equal to plain: {name}", flush=True)


def msm_point_ops(scalars: torch.Tensor, nw: int, curve) -> float:
    """Montgomery products that MSMs over (rows, I, 8) scalars of ``nw``
    4-bit windows on ``curve`` need: per point 3 doublings (2Q, 4Q, 8Q)
    and 11 additions for its 16 multiples; per row and window one addition
    per nonzero digit but the first; below the top window a row's ladder
    of 4 doublings and one addition per window.  A doubling costs what the
    curve's a lets it (``dbl_muls``)."""
    from spartan2_tpu_torch.ec.comb import scalar_digits
    from spartan2_tpu_torch.ec.msm import MSM_WINDOW_BITS

    rows, n = scalars.shape[:2]
    nzd = scalar_digits(scalars, nw, MSM_WINDOW_BITS) != 0  # (windows, rows, I)
    dbl = dbl_muls(curve)
    return (rows * n * (11 * MONT_MULS_PER_ADD + 3 * dbl)
            + int(nzd.sum() - nzd.any(2).sum()) * MONT_MULS_PER_ADD
            + rows * (nw - 1) * (4 * dbl + MONT_MULS_PER_ADD))


def comb_bound_args(scalars: torch.Tensor, n_win: int) -> tuple:
    """(bytes, Montgomery products) a comb rows-MSM of (R, C, 8) scalars
    needs: the scalars read, one 96-byte table point per nonzero digit and
    the rows written; a row of k such points sums them with k - 1
    additions."""
    from spartan2_tpu_torch.ec.comb import scalar_digits

    R, C = scalars.shape[:2]
    nz = (scalar_digits(scalars, n_win) != 0).sum((0, 2))
    adds = int((nz - 1).clamp(min=0).sum())
    return R * C * 32 + int(nz.sum()) * 96 + R * 96, adds * MONT_MULS_PER_ADD


def comb_build_bound(C: int, n_win: int, curve) -> tuple:
    """(bytes, products) a comb table build needs: the generators read and
    the table written once; 6 doublings from one window's base to the next,
    chained, and 62 additions a window and generator."""
    return (2 * C * 32 + n_win * 64 * C * 96,
            C * (6 * (n_win - 1) * dbl_muls(curve) + n_win * 62 * MONT_MULS_PER_ADD))


def check_comb_build(curve, gens, h, n_small: int, dev, F, prefix: str = ""):
    """The three tables a Hyrax key builds at first use (pcs/hyrax.py: full
    scalars over the C generators, the witness's small scalars over them,
    full scalars over h), each against its plain version limb for limb:
    the small table against the first windows of the full plain table (a
    window does not depend on the windows after it,
    tests/test_torch_comb_build_layout.py), h's table against its plain
    version on the host.  -> the three tables' records (full, small, h),
    each with its device ms."""
    from spartan2_tpu_torch.ec.comb import comb_build, comb_build_plain, n_windows
    from spartan2_tpu_torch.field.limbs import to_device
    from spartan2_tpu_torch.pcs.hyrax import FULL_BITS

    Fb, C, nw = curve.base, len(gens), n_windows(FULL_BITS)
    gx = to_device([g[0] for g in gens], Fb, dev, mont=True)
    gy = to_device([g[1] for g in gens], Fb, dev, mont=True)
    hx, hy = to_device([h[0]], Fb, dev, mont=True), to_device([h[1]], Fb, dev, mont=True)
    want, pms = once_ms(lambda: comb_build_plain(gx, gy, nw, curve))
    same_or_raise(f"{prefix}comb_build {nw} windows x {C}", comb_build(gx, gy, nw, curve),
                  want, F)
    same_or_raise(f"{prefix}comb_build {n_small} windows x {C} (the plain table's first "
                  f"{n_small} windows)", comb_build(gx, gy, n_small, curve), want[:n_small], F)
    want_h, hpms = host_plain(lambda x, y: comb_build_plain(x, y, nw, curve), hx, hy)
    same_or_raise(f"{prefix}comb_build {nw} windows x 1 (h)", comb_build(hx, hy, nw, curve).cpu(),
                  want_h, F)
    del want
    recs = []
    for n_win, x, y, pm in ((nw, gx, gy, pms), (n_small, gx, gy, None), (nw, hx, hy, hpms)):
        def call(x=x, y=y, n_win=n_win):
            comb_build(x, y, n_win, curve)

        rec = detail_record(f"{prefix}comb_build {n_win} x {x.shape[0]}", cuda_ms(call, 3), pm,
                            *comb_build_bound(x.shape[0], n_win, curve))
        rec["device_ms"] = device_ms(call, 3)
        recs.append(rec)
    return recs


def gathered(mats) -> int:
    """Distinct entries of the input vector that SpMVs over ``mats`` read."""
    return int(torch.unique(torch.cat([m.indices for m in mats])).numel())


def check_spmv_skewed(F, dev) -> list:
    """Kernel 1 on three matrices whose rows span every class: 2^18 rows of
    0 to 3 entries, 2000 of 17 to 256 (a warp each) and 12 of 257 to 6000
    (a block each) in each matrix; spmv with a prefix, spmv_combine with
    the joint classes and spmv_batched at I = 4 against their plain
    versions -> detail records."""
    import numpy as np

    from spartan2_tpu_torch.r1cs.sparse import (
        DeviceCSR, RowClasses, spmv, spmv_batched, spmv_batched_plain, spmv_combine,
        spmv_combine_plain, spmv_plain)

    n = 1 << 18
    rng = np.random.default_rng(11)
    gen = torch.Generator().manual_seed(11)
    mats = []
    for _ in range(3):
        lengths = rng.integers(0, 4, n)
        lengths[rng.choice(n, 2000, replace=False)] = rng.integers(17, 257, 2000)
        lengths[rng.choice(n, 12, replace=False)] = rng.integers(257, 6001, 12)
        rows_e = np.repeat(np.arange(n), lengths)
        cols_e = rng.integers(0, n, len(rows_e))
        vals = rand_field(len(rows_e), F, gen, "cpu").numpy()
        mats.append(DeviceCSR.from_arrays(rows_e, cols_e, vals, n, dev))
    joint = RowClasses.joint(mats)
    if any(c.n_warp == 0 or c.n_block == 0 for c in [m.classes for m in mats] + [joint]):
        raise RuntimeError("skewed SpMV: a matrix lacks warp or block rows")
    z = rand_field(n, F, gen, dev)
    zb = rand_field(4 * n, F, gen, dev).reshape(4, n, 8)
    prefix = rand_field(3 * n, F, gen, dev).reshape(3, n, 8)
    rr = random.Random(12).randrange(F.modulus)
    nnz = sum(m.indices.shape[0] for m in mats)
    cls = (f"warp rows {[m.classes.n_warp for m in mats]}, block rows "
           f"{[m.classes.n_block for m in mats]}, joint {joint.n_warp} / {joint.n_block}")
    out = []
    for name, fn, plain, nbytes, muls in (
            ("spmv with a prefix", lambda: spmv(mats, z, F, prefix),
             lambda: spmv_plain(mats, z, F, prefix),
             nnz * 36 + gathered(mats) * 32 + 6 * n * 32, nnz),
            ("spmv_combine", lambda: spmv_combine(mats, z, rr, F, joint),
             lambda: spmv_combine_plain(mats, z, rr, F),
             nnz * 36 + gathered(mats) * 32 + n * 32, nnz + 2 * n),
            ("spmv_batched I = 4", lambda: spmv_batched(mats, zb, F),
             lambda: spmv_batched_plain(mats, zb, F),
             nnz * 36 + 4 * gathered(mats) * 32 + 12 * n * 32, 4 * nnz)):
        want, pms = once_ms(plain)
        same_or_raise(f"{name} on skewed matrices ({cls})", fn(), want, F)
        out.append(detail_record(f"{name}, skewed 2^18 rows, {nnz} entries ({cls})",
                                 cuda_ms(fn, 5), pms, nbytes, muls))
    return out


def check_eq_tables(F, fac: torch.Tensor, eq_pms: float, entries: dict) -> list:
    """The eq table at 2^m from ``fac`` (held against its plain version by
    the caller, in eq_pms ms) timed, and the outer sum-check's plan (its
    20 tables at m = 20) in one sp2_eq_tables launch against eq_tables_plain
    -> kernel records.  Bounds: 2^m elements written and one product each
    (the doubling's need)."""
    from spartan2_tpu_torch.sumcheck.device import (
        eq_factors, eq_table, eq_tables, eq_tables_plain)
    from spartan2_tpu_torch.sumcheck.prove import SumcheckProverCubicEq

    m = fac.shape[0] // 2
    n = 1 << m
    out = [kernel_record(
        "eq_table", "spartan2_tpu/polys/eq.py:79", entries.get("sp2_eq_table", 0),
        NONZK_COUNTS.replace("wrapper calls", "sp2_eq_table entry calls"),
        cuda_ms(lambda: eq_table(fac, F), 5), eq_pms, n * 32 + 2 * m * 32, n,
        "spartan2_tpu_torch/csrc/sumcheck.cu")]
    out[0]["device_ms"] = device_ms(lambda: eq_table(fac, F), 5)
    rng = random.Random(17)
    taus = [rng.randrange(F.modulus) for _ in range(m)]
    keys = SumcheckProverCubicEq.table_keys(m)
    ranges = sorted({k for pair in keys for k in pair if k is not None})
    ms = [b - a for a, b in ranges]
    tfac = torch.cat([eq_factors(taus[a:b], F, fac.device) for a, b in ranges])
    want, tpms = once_ms(lambda: torch.cat(eq_tables_plain(tfac, ms, F)))
    same_or_raise(f"eq_tables, the outer plan's {len(ms)} tables (m = {ms})",
                  torch.cat(eq_tables(tfac, ms, F)), want, F)
    tn = sum(1 << k for k in ms)
    out.append(kernel_record(
        "eq_tables", "spartan2_tpu/polys/eq.py:79", entries.get("sp2_eq_tables", 0),
        NONZK_COUNTS.replace("wrapper calls", "sp2_eq_tables entry calls"),
        cuda_ms(lambda: eq_tables(tfac, ms, F), 10), tpms, tn * 32 + 2 * sum(ms) * 32, tn,
        "spartan2_tpu_torch/csrc/sumcheck.cu"))
    out[1]["device_ms"] = device_ms(lambda: eq_tables(tfac, ms, F), 10)
    return out


def edge_field(n: int, spec, gen: torch.Generator, device) -> torch.Tensor:
    """``rand_field`` with zeros and p - 1 among the entries."""
    from spartan2_tpu_torch.field.limbs import to_device

    v = rand_field(n, spec, gen, device)
    v[::7] = 0
    v[3::11] = to_device([spec.modulus - 1], spec, device)[0]
    return v


def bind_first_case(name: str, mode: int, n: int, vecs: list, r: int, F, reps: int = 5,
                    slot: bool = False) -> tuple:
    """Kernel A's round with the previous bind folded in, over ``vecs``
    carrying n rows (bound in place to n/2, the round over n/2; the eq
    shared by K > 1 instances into a second buffer): with host r
    (round_sums_bind, the ZK drivers' form) or, given ``slot``, r read
    from a challenge slot (round_sums, the enqueued form), against the
    plain bind-then-evaluate on the card: the sums and every bound vector
    equal -> (kernel ms over ``reps`` runs on fresh copies by CUDA events,
    plain ms, the kernel's device ms by the profiler)."""
    from spartan2_tpu_torch.field import ops
    from spartan2_tpu_torch.field.limbs import to_device
    from spartan2_tpu_torch.sumcheck.device import (round_sums, round_sums_bind,
                                                    round_sums_bind_plain)

    dev = vecs[0].device
    r_slot = to_device([r, (1 - r) % F.modulus], F, dev, mont=True)
    # a cubic round of K > 1 instances binds their shared eq into a second buffer
    shared = mode == 0 and vecs[1].dim() == 3 and vecs[1].shape[0] > 1
    eq_k = torch.empty_like(vecs[0][: n // 2]) if shared else None
    eq_p = torch.empty_like(vecs[0][: n // 2]) if shared else None

    def kernel(vs):
        if slot:
            return round_sums(mode, n // 2, vs, F, r_slot)
        return round_sums_bind(mode, n // 2, vs, r, F, eq_out=eq_k)

    k_vecs, p_vecs = [v.clone() for v in vecs], [v.clone() for v in vecs]
    got = kernel(k_vecs)
    want, pms = once_ms(lambda: round_sums_bind_plain(mode, n // 2, p_vecs,
                                                      ops.const(r, F, device=dev), F, eq_p))
    if not (torch.equal(got, want) and all(torch.equal(a, b) for a, b in zip(k_vecs, p_vecs))
            and (not shared or torch.equal(eq_k, eq_p))):
        raise RuntimeError(f"kernel A bind-first ({name}) differs from plain "
                           "bind-then-evaluate")
    print(f"equal to plain bind-then-evaluate: kernel A {name}", flush=True)
    del k_vecs, p_vecs
    if not reps:
        return None, pms, None
    copies = iter([[v.clone() for v in vecs] for _ in range(2 * reps + 3)])
    ms = cuda_ms(lambda: kernel(next(copies)), reps)
    dms = device_ms(lambda: kernel(next(copies)), reps)
    return ms, pms, dms


def sums_device_ms(mode: int, n: int, vecs: list, F, reps: int = 5) -> float:
    """Kernel A's device ms for the round over n rows without a bind (the
    wrappers that return ints also pull the sums to the host)."""
    from spartan2_tpu_torch.sumcheck.device import round_sums_batched

    return device_ms(lambda: round_sums_batched(mode, n, vecs, F), reps)


def bind_first_bound(mode: int, n: int, vecs: list) -> tuple:
    """(bytes, Montgomery products) the bind-first round over ``vecs``
    carrying n rows needs: each vector read once over its n rows and its
    n / 2 bound rows written; a bind product per bound row, and per pair of
    the round 3 reduced products (A B at 0, 2, 3) and 3 unreduced ones
    (half a product each) for CUBIC, 2 unreduced for QUAD."""
    rows = sum(v.shape[0] if v.dim() == 3 else 1 for v in vecs)  # instance-vectors
    pairs = n // 4 * (vecs[1].shape[0] if vecs[1].dim() == 3 else 1)
    per_pair = 3 + 3 * 0.5 if mode == 0 else 2 * 0.5
    return rows * (n + n // 2) * 32, rows * (n // 2) + pairs * per_pair


def g_muls(pairs: int, row_pairs: int, sums: int) -> float:
    """Montgomery products kernel G's sums need over ``pairs`` pairs in
    left rows of ``row_pairs`` pairs: per pair and active sum one reduced
    product for f and one unreduced product by ER (half a product); per
    left row and sum one reduction (half a product) and one product by EL."""
    rows = -(-pairs // row_pairs)
    return sums * (1.5 * pairs + 1.5 * rows)


def hyrax_bind_bound(R: int, C: int) -> tuple:
    """(bytes, Montgomery products) kernel 4 needs at R x C: L and the rows
    read once, LZ written once; R C unreduced products (half a product
    each), and per column one reduction and one from_mont (half each)."""
    return R * C * 32 + R * 32 + C * 32, 0.5 * R * C + C


def compare_kernels(pk, prep, proof, launches: dict):
    """Each kernel against its plain version at the main path's shapes;
    -> (kernel records for the JSON line, detail records)."""
    from spartan2_tpu_torch.ec.comb import comb_rows, comb_rows_plain, n_windows, scalar_digits
    from spartan2_tpu_torch.ec.msm import msm, msm_plain, msm_windows, to_jacobian
    from spartan2_tpu_torch.field.limbs import to_device
    from spartan2_tpu_torch.pcs.hyrax import (
        FULL_BITS, SMALL_BITS, hyrax_bind, hyrax_bind_plain)
    from spartan2_tpu_torch.polys.eq import eq_evals_host
    from spartan2_tpu_torch.r1cs.sparse import (
        spmv, spmv_combine, spmv_combine_plain, spmv_plain)
    from spartan2_tpu_torch.sumcheck.device import (
        CUBIC, DOT, QUAD, bind, bind_plain, eq_factors, eq_table, eq_table_plain,
        round_evals, round_evals_plain)

    engine, S = pk.engine, pk.S
    curve = engine.curve
    F = engine.scalar
    dev = pk.device
    gen = torch.Generator().manual_seed(0)
    rr = random.Random(5).randrange(F.modulus)
    out, detail = [], []

    def check(name, got, plain):
        """Kernel output ``got`` against plain() -> plain milliseconds."""
        want, ms = once_ms(plain)
        same_or_raise(name, got, want, F)
        return ms

    # Bounds count what the function needs for this run's data: each input
    # entry it reads once (for an SpMV, the vector entries its columns
    # gather, not the whole vector), each output once, and the Montgomery
    # products of the additions and doublings it must do.
    def record_kernel(name, replaces, ms, plain_ms, nbytes, muls):
        out.append(kernel_record(name, replaces, launches[name], NONZK_COUNTS,
                                 ms, plain_ms, nbytes, muls))

    def record_detail(name, ms, plain_ms, nbytes, muls):
        detail.append(detail_record(name, ms, plain_ms, nbytes, muls))

    # kernel 1: the prove's suffix SpMV with the cached-prefix epilogue
    mats = [S.dev[n + "_sfx"] for n in "ABC"]
    z = rand_field(S.num_cols, F, gen, dev)
    prefix = rand_field(3 * S.num_cons, F, gen, dev).reshape(3, S.num_cons, 8)
    pms = check("spmv (shape_mv_inc)", spmv(mats, z, F, prefix),
                lambda: spmv_plain(mats, z, F, prefix))
    nnz = sum(m.indices.shape[0] for m in mats)
    record_kernel("spmv", "spartan2_tpu/r1cs/shape.py:288",
                  cuda_ms(lambda: spmv(mats, z, F, prefix), 10), pms,
                  nnz * 36 + gathered(mats) * 32 + 6 * S.num_cons * 32, nnz)
    # poly_ABC: the transposes with the a + r (b + r c) epilogue
    tmats = [S.dev[n + "t"] for n in "ABC"]
    eqv = rand_field(S.num_cons, F, gen, dev)
    tcls = S.dev["t_classes"]
    pms = check("spmv_combine (shape_abc)", spmv_combine(tmats, eqv, rr, F, tcls),
                lambda: spmv_combine_plain(tmats, eqv, rr, F))
    tnnz = sum(m.indices.shape[0] for m in tmats)
    record_detail("spmv_combine poly_ABC",
                  cuda_ms(lambda: spmv_combine(tmats, eqv, rr, F, tcls), 10), pms,
                  tnnz * 36 + gathered(tmats) * 32 + S.num_cols * 32,
                  tnnz + 2 * S.num_cols)
    # the prep's prefix SpMV
    pmats = [S.dev[n + "_pre"] for n in "ABC"]
    lo = S.num_shared + S.num_precommitted
    wp = prep.ps.W_prefix
    pms = check("spmv (shape_mv_pre)", spmv(pmats, wp, F),
                lambda: spmv_plain(pmats, wp, F))
    pnnz = sum(m.indices.shape[0] for m in pmats)
    record_detail("spmv prefix (prep)", cuda_ms(lambda: spmv(pmats, wp, F), 5), pms,
                  pnnz * 36 + gathered(pmats) * 32 + 3 * S.num_cons * 32, pnnz)

    detail.extend(check_spmv_skewed(F, dev))

    # kernel 2: eq table, and one outer round (evaluations + bind) at 2^m
    n = S.num_cons
    m = n.bit_length() - 1
    fac = eq_factors([random.Random(7 + j).randrange(F.modulus) for j in range(m)],
                     F, dev)
    eq_pms = check(f"eq_table 2^{m}", eq_table(fac, F), lambda: eq_table_plain(fac, F))
    vecs = [rand_field(n, F, gen, dev) for _ in range(4)]
    check("round_evals cubic", round_evals(CUBIC, n, vecs, F),
          lambda: round_evals_plain(CUBIC, n, vecs, F))
    quad_pms = check("round_evals quad", round_evals(QUAD, n, vecs[:2], F),
                     lambda: round_evals_plain(QUAD, n, vecs[:2], F))
    dot_pms = check("round_evals dot", round_evals(DOT, n, vecs[:2], F),
                    lambda: round_evals_plain(DOT, n, vecs[:2], F))
    v1 = [v.clone() for v in vecs]
    v2 = [v.clone() for v in vecs]
    bind(v1, n, rr, F)
    check("bind", torch.stack(v1), lambda: (bind_plain(v2, n, rr, F),
                                            torch.stack(v2))[1])

    # kernel A's round with the previous round's bind folded in, as the
    # enqueued provers run it (r from the round finish's slot): eq, A, B, C
    # carry 2^m rows, bound to 2^(m-1), the round's sums over them
    ms, pms, dms = bind_first_case(f"cubic, bind-first, 2^{m} rows (challenge slot)", CUBIC,
                                   n, vecs, rr, F, slot=True)
    record_kernel("sumcheck", "spartan2_tpu/sumcheck/prove.py:244", ms, pms,
                  *bind_first_bound(CUBIC, n, vecs))
    out[-1]["device_ms"] = dms
    ms, pms, dms = bind_first_case(f"quad, bind-first, 2^{m} rows (challenge slot)", QUAD, n,
                                   vecs[:2], rr, F, slot=True)
    record_detail(f"round_sums quad bind-first 2^{m} -> 2^{m - 1}", ms, pms,
                  *bind_first_bound(QUAD, n, vecs[:2]))
    detail[-1]["device_ms"] = dms
    out.extend(check_eq_tables(F, fac, eq_pms, launches["sumcheck_entries"]))
    record_detail(f"round_evals quad 2^{m}",
                  cuda_ms(lambda: round_evals(QUAD, n, vecs[:2], F), 5), quad_pms,
                  2 * n * 32, n)
    detail[-1]["device_ms"] = sums_device_ms(QUAD, n, vecs[:2], F)
    record_detail(f"round_evals dot 2^{m}",
                  cuda_ms(lambda: round_evals(DOT, n, vecs[:2], F), 5), dot_pms,
                  2 * n * 32, n)
    detail[-1]["device_ms"] = sums_device_ms(DOT, n, vecs[:2], F)
    # the verifier's MLE evaluation of A, B, C (shape_eval): two eq
    # tables, one SpMV over T_y and three dot products
    r_y = [random.Random(40 + j).randrange(F.modulus) for j in range(m)]
    r_x = [random.Random(80 + j).randrange(F.modulus) for j in range(m)]
    fnnz = S.A.nnz + S.B.nnz + S.C.nnz

    def shape_eval_plain():
        Tx = eq_table_plain(eq_factors(r_x, F, dev), F)
        Ty = eq_table_plain(eq_factors(r_y, F, dev), F)[: S.num_cols]
        M = spmv_plain([S.dev[k] for k in "ABC"], Ty, F)
        return torch.cat([round_evals_plain(DOT, S.num_cons, [Tx, M[k]], F)
                          for k in range(3)])

    pms = check("evaluate_at (shape_eval)", list(S.evaluate_at(r_x, r_y)),
                shape_eval_plain)
    record_detail("evaluate_at (shape_eval)",
                  cuda_ms(lambda: S.evaluate_at(r_x, r_y), 3), pms,
                  2 * n * 32 + fnnz * 36 + 3 * n * 32, 2 * n * m + fnnz + 3 * n)

    # kernel 3: the PCS comb rows-MSM over [LZ, d_vec] (full width)
    comb_full = pk.ck.comb(FULL_BITS)
    C = pk.ck.num_cols
    nw = comb_full.n_win
    sc = rand_field(2 * C, F, gen, dev).reshape(2, C, 8)
    pms = check("comb_rows [LZ, d_vec]", comb_rows(sc, comb_full.table, curve),
                lambda: comb_rows_plain(sc, comb_full.table, curve))
    # the work depends on the data: one table point per nonzero digit, and
    # one addition fewer than those points in each row
    record_kernel("comb", "spartan2_tpu/ec/comb.py:123",
                  cuda_ms(lambda: comb_rows(sc, comb_full.table, curve), 5), pms,
                  *comb_bound_args(sc, nw))
    # the blinds' multiples of h (every blinding and rerandomize): C = 1,
    # 16 rows; and one full-width row
    comb_h = pk.ck.comb_h()
    for name, sc1, tab in (
            (f"comb_rows 16 x 1 (h, {comb_h.n_win} windows)",
             rand_field(16, F, gen, dev).reshape(16, 1, 8), comb_h.table),
            (f"comb_rows 1 x {C} ({nw} windows)",
             rand_field(C, F, gen, dev).reshape(1, C, 8), comb_full.table)):
        pms = check(name, comb_rows(sc1, tab, curve),
                    lambda: comb_rows_plain(sc1, tab, curve))
        record_detail(name, cuda_ms(lambda: comb_rows(sc1, tab, curve), 10), pms,
                      *comb_bound_args(sc1, tab.shape[0]))
    rows_pre = S.num_precommitted // S.width
    small = pk.ck.comb(SMALL_BITS)
    full, *rest = check_comb_build(curve, pk.ck.ck, pk.ck.h, small.n_win, dev, F)
    out.append(kernel_record(
        "comb_build", "spartan2_tpu/ec/comb.py:71", launches["comb_entries"]["sp2_comb_build"],
        "sp2_comb_build entry calls on the SpartanSNARK path: setup, prep_prove, three "
        "proves, verify (the key's three tables at first use, two launches each: the bases "
        f"and the digits); ms, device_ms and the bound at {full['name'].split(' ', 1)[1]}",
        full["ms"], full["plain_ms"], *comb_build_bound(C, n_windows(FULL_BITS), curve),
        source="spartan2_tpu_torch/csrc/comb.cu"))
    out[-1]["device_ms"] = full["device_ms"]
    detail.extend(rest)
    wit = prep.ps.W[S.num_shared : S.num_shared + S.num_precommitted]
    scp = to_device(wit, F, dev).reshape(rows_pre, C, 8)
    pms = check("comb_rows precommitted witness", comb_rows(scp, small.table, curve),
                lambda: comb_rows_plain(scp, small.table, curve))
    nz = int((scalar_digits(scp, small.n_win) != 0).sum())
    record_detail(f"comb_rows {rows_pre} x {C}, {small.n_win} windows, "
                  f"{nz} nonzero digits",
                  cuda_ms(lambda: comb_rows(scp, small.table, curve), 2), pms,
                  *comb_bound_args(scp, small.n_win))

    # kernel 4: the PCS row bind
    R = S.num_vars // C
    L = rand_field(R, F, gen, dev)
    poly = rand_field(R * C, F, gen, dev).reshape(R, C, 8)
    pms = check("hyrax_bind", hyrax_bind(L, poly, F),
                lambda: hyrax_bind_plain(L, poly, F))
    record_kernel("hyrax_bind", "spartan2_tpu/pcs/hyrax.py:300",
                  cuda_ms(lambda: hyrax_bind(L, poly, F), 10), pms,
                  *hyrax_bind_bound(R, C))
    out[-1]["device_ms"] = device_ms(lambda: hyrax_bind(L, poly, F), 10)

    # kernel 5: the verifier's fold of the proof's row commitments
    comm_W, _ = proof.U.to_regular(engine.pcs)
    rows = len(comm_W.comm)
    Lv = eq_evals_host(F, [random.Random(120 + j).randrange(F.modulus)
                           for j in range(rows.bit_length() - 1)])
    sc = to_device(Lv, F, dev)
    pts = to_jacobian(comm_W.comm, curve, dev)
    want, pms = host_plain(lambda s_, p_: msm_plain(s_, p_, curve), sc, pts)
    same_or_raise(f"msm {rows} points", msm(sc, pts, curve).cpu(), want, F)
    record_kernel("msm", "spartan2_tpu/ec/device.py:398",
                  cuda_ms(lambda: msm(sc, pts, curve), 5), pms,
                  rows * (32 + 96) + 96, msm_point_ops(sc[None], msm_windows(FULL_BITS), curve))
    return out, detail


ZK_PATH = "on the SpartanZkSNARK path: setup_from_shape, prep_prove, four proves, verify"


def compare_zk_kernels(S, zk_proof, proof, zk_launches: dict, launches: dict,
                       nn_launches: dict):
    """Kernels A, B and C and the whole-z SpMV against their plain
    versions at the ZK path's shapes -> (kernel records, detail records);
    kernel B's records also count its launches on the other two paths."""
    from spartan2_tpu_torch.ec.msm import msm_rows, msm_rows_plain, msm_windows, to_jacobian
    from spartan2_tpu_torch.field.limbs import to_device
    from spartan2_tpu_torch.pcs.hyrax import FULL_BITS
    from spartan2_tpu_torch.r1cs.sparse import spmv, spmv_plain
    from spartan2_tpu_torch.sumcheck.device import (
        CUBIC, QUAD, bind, bind_plain, round_evals_batched, round_evals_batched_plain)
    from spartan2_tpu_torch.provider.engines import get_engine

    engine = get_engine("P256HyraxEngine")
    curve, F = engine.curve, engine.scalar
    dev = S.dev["device"]
    gen = torch.Generator().manual_seed(1)
    rr = random.Random(9).randrange(F.modulus)
    out, detail = [], []
    sc_calls = zk_launches["sumcheck"]

    def plain_ms(name, got, plain):
        want, ms = once_ms(plain)
        same_or_raise(name, got, want, F)
        return ms

    # kernel A at 2^20: the round as it is (the first of a sum-check) and the
    # bind of E and K instances of A, B, C, then the round with the bind
    # folded in, timed on copies made before the clock starts
    n = S.num_cons
    E = rand_field(n, F, gen, dev)
    reps = 5
    for K in (1, 2):
        abc = [rand_field(K * n, F, gen, dev).reshape(K, n, 8) for _ in range(3)]
        vecs = [E] + abc
        plain_ms(f"zk cubic round evals K={K}", round_evals_batched(CUBIC, n, vecs, F),
                 lambda: _pull_ints(round_evals_batched_plain(CUBIC, n, vecs, F), F, K))
        v1 = [v.clone() for v in vecs]
        v2 = [v.clone() for v in vecs]
        bind(v1, n, rr, F)
        plain_ms(f"zk bind K={K}", torch.cat([v.reshape(-1, 8) for v in v1]),
                 lambda: (bind_plain(v2, n, rr, F),
                          torch.cat([v.reshape(-1, 8) for v in v2]))[1])
        # the round with the previous bind folded in: E and K instances of
        # A, B, C carry 2^20 rows, bound to 2^19 (E once), the sums over them
        ms, pms, dms = bind_first_case(
            f"zk cubic, bind-first, K = {K}, 2^20 rows (shared eq)", CUBIC, n, vecs, rr, F,
            reps)
        nbytes, muls = bind_first_bound(CUBIC, n, vecs)
        if K == 1:
            out.append(kernel_record(
                "zk_rounds", "spartan2_tpu/sumcheck/zk_device.py:102",
                sum(sc_calls.get(e, 0) for e in ("sp2_round_evals", "sp2_round_bind_evals",
                                                 "sp2_bind")),
                f"sp2_round_evals, sp2_round_bind_evals and sp2_bind entry calls {ZK_PATH} "
                "(the ZK cubic and quad rounds, each sum-check's last bind, and verify's "
                "3 dot products)",
                ms, pms, nbytes, muls, "spartan2_tpu_torch/csrc/sumcheck.cu"))
            out[-1]["device_ms"] = dms
        else:
            detail.append(detail_record(f"zk cubic round bind-first K={K} at "
                                        f"2^{n.bit_length() - 1} -> 2^{n.bit_length() - 2}",
                                        ms, pms, nbytes, muls))
            detail[-1]["device_ms"] = dms
    # edge values: zeros and p - 1 among the entries, r in {0, 1, random},
    # K = 2 over a shared eq and the quad K = 2, at 2^12 rows
    for r_e in (0, 1, rr):
        ve = [edge_field(1 << 12, F, gen, dev)] + [
            edge_field(2 << 12, F, gen, dev).reshape(2, 1 << 12, 8) for _ in range(3)]
        bind_first_case(f"zk cubic, bind-first, K = 2, edge values, r = {r_e}", CUBIC,
                        1 << 12, ve, r_e, F, 0)
        bind_first_case(f"zk quad, bind-first, K = 2, edge values, r = {r_e}", QUAD,
                        1 << 12, ve[1:3], r_e, F, 0)
    # the quad round with its bind at 2^20 rows (2^19 after the bind)
    vq = [rand_field(n, F, gen, dev)[None] for _ in range(2)]
    ms, pms, dms = bind_first_case("zk quad, bind-first, 2^20 rows", QUAD, n, vq, rr, F, reps)
    detail.append(detail_record("zk quad round bind-first 2^20 -> 2^19", ms, pms,
                                *bind_first_bound(QUAD, n, vq)))
    detail[-1]["device_ms"] = dms
    del vq
    # kernel A's quad round at the inner sum-check's width 2^19, stride num_cols
    nq = S.num_vars
    az = [rand_field(S.num_cols, F, gen, dev)[None] for _ in range(2)]
    pms = plain_ms("zk quad round evals", round_evals_batched(QUAD, nq, az, F),
                   lambda: _pull_ints(round_evals_batched_plain(QUAD, nq, az, F), F, 1))
    detail.append(detail_record(
        f"zk quad round evals at 2^{nq.bit_length() - 1}",
        cuda_ms(lambda: round_evals_batched(QUAD, nq, az, F), reps), pms,
        2 * nq * 32, nq))
    detail[-1]["device_ms"] = sums_device_ms(QUAD, nq, az, F)

    b_out, b_detail = check_kernel_b(S, F, dev, sc_calls, launches, nn_launches, reps)
    out.extend(b_out)
    detail.extend(b_detail)

    # kernel C: the NIFS verifier's fold of the verifier-circuit W rows
    # (43 rows of 2 points) with this run's proof points and weights
    # [1, r], and 256 rows of 2 (two SHA-256 witness commitments)
    nw = msm_windows(FULL_BITS)
    r_fold = random.Random(13).randrange(F.modulus)
    w = to_device([1, r_fold], F, dev)
    c_vc = [zk_proof.random_U.comm_W.comm,
            engine.pcs.combine_commitments(zk_proof.U_verifier.comm_w_per_round).comm]
    c_big = [zk_proof.U.to_regular(engine.pcs)[0].comm,
             proof.U.to_regular(engine.pcs)[0].comm]
    for cs in (c_vc, c_big):
        R = len(cs[0])
        sc = w.expand(R, 2, 8).contiguous()
        pts = to_jacobian([pt for row in zip(*cs) for pt in row], curve,
                          dev).reshape(R, 2, 3, 8)
        want, pms = host_plain(lambda s_, p_: msm_rows_plain(s_, p_, curve), sc, pts)
        same_or_raise(f"msm_rows R={R} I=2", msm_rows(sc, pts, curve).cpu(), want, F)
        ms = cuda_ms(lambda: msm_rows(sc, pts, curve), reps)
        nbytes, muls = R * 2 * (32 + 96) + R * 96, msm_point_ops(sc, nw, curve)
        if R == len(c_vc[0]):
            out.append(kernel_record(
                "msm_rows", "spartan2_tpu/ec/device.py:424",
                zk_launches["msm"].get("sp2_msm_rows", 0),
                f"sp2_msm_rows entry calls {ZK_PATH} (the NIFS verifier's fold of "
                "W; its E fold has 32 points and stays on the host)",
                ms, pms, nbytes, muls, "spartan2_tpu_torch/csrc/msm.cu"))
        else:
            detail.append(detail_record(f"msm_rows R={R} I=2", ms, pms, nbytes, muls))

    # shape_mv: Az, Bz, Cz over the whole z (the ZK prover has no prefix cache)
    mats = [S.dev[k] for k in "ABC"]
    zz = rand_field(S.num_cols, F, gen, dev)
    pms = plain_ms("spmv (shape_mv)", spmv(mats, zz, F), lambda: spmv_plain(mats, zz, F))
    nnz = sum(m.indices.shape[0] for m in mats)
    out.append(kernel_record(
        "shape_mv", "spartan2_tpu/r1cs/shape.py:237",
        zk_launches["spmv"].get("sp2_spmv", 0),
        f"sp2_spmv entry calls {ZK_PATH} (per prove the whole-z SpMV and the "
        "poly_ABC transposes; verify's MLE evaluation)",
        cuda_ms(lambda: spmv(mats, zz, F), 5), pms,
        nnz * 36 + gathered(mats) * 32 + 3 * S.num_cons * 32, nnz,
        "spartan2_tpu_torch/csrc/spmv.cu"))
    return out, detail


def check_kernel_b(S, F, dev, sc_calls: dict, launches: dict, nn_launches: dict,
                   reps: int):
    """Kernel B's sums and bind at the inner round 0 of S against their plain
    versions, the sums also at the edges -> (kernel records, detail records)."""
    from spartan2_tpu_torch.sumcheck.device import (
        QUAD, bind, inner0_bind, inner0_bind_plain, inner0_evals, inner0_evals_plain,
        inner0_sums, new_ticket, round_evals_batched)
    from tools._timing import kernel_us

    gen = torch.Generator().manual_seed(11)
    rr = random.Random(19).randrange(F.modulus)
    out, detail = [], []

    def plain_ms(name, got, plain):
        want, ms = once_ms(plain)
        same_or_raise(name, got, want, F)
        return ms

    def pairs(evals):
        p = F.modulus
        return [(e0, (e0 - low + cross) % p) for e0, low, cross in evals]

    # kernel B: the structured inner round 0 at num_cols, its sums and its
    # bind each against its plain version and timed alone
    nv, ne = S.num_vars, S.num_cols - S.num_vars
    abc, z = (rand_field(S.num_cols, F, gen, dev)[None] for _ in range(2))
    ev_pms = plain_ms(f"inner0 evals num_cols={S.num_cols}", inner0_evals(abc, z, nv, ne, F),
                      lambda: pairs(_pull_ints(inner0_evals_plain(abc, z, nv, ne, F), F, 1)))
    # the edges: one extra column, every column extra (no main block), and
    # K = 2, over edge values (zeros, 1 and p - 1 among the entries)
    for nv_e, ne_e, K in ((1 << 12, 1, 1), (1 << 12, 1 << 12, 1), (1 << 12, 300, 2)):
        ae, ze = (edge_field(K * (nv_e + ne_e), F, gen, dev).reshape(K, nv_e + ne_e, 8)
                  for _ in range(2))
        plain_ms(f"inner0 evals num_vars={nv_e}, num_extra={ne_e}, K={K}, edge values",
                 inner0_evals(ae, ze, nv_e, ne_e, F),
                 lambda: pairs(_pull_ints(inner0_evals_plain(ae, ze, nv_e, ne_e, F), F, K)))
    a1, z1, a2, z2 = abc.clone(), z.clone(), abc.clone(), z.clone()
    inner0_bind(a1, z1, rr, nv, ne, F)
    bd_pms = plain_ms("inner0 bind", torch.cat([a1, z1]),
                      lambda: (inner0_bind_plain(a2, z2, rr, nv, ne, F), torch.cat([a2, z2]))[1])
    del a2, z2
    ticket = new_ticket(dev)

    def sums():
        inner0_sums(abc[0], z[0], nv, ne, F, ticket)

    flush = torch.empty(32 << 20, dtype=torch.int32, device=dev)  # 128 MB, above the L2

    def cold_sums():
        flush.fill_(1)
        sums()

    cold = None
    for _ in range(2):  # a profile recorded no launch at times: once more
        ks = [k for name, k in kernel_us(cold_sums, 10).items() if "inner0_evals" in name]
        if ks:
            cold = ks[0]["us"] / 1e3
            break
    del flush
    sc_nn = nn_launches["sumcheck"]
    sc_main = launches["sumcheck_entries"]
    out.append(kernel_record(
        "inner0_evals", "spartan2_tpu/sumcheck/zk_device.py:284",
        sc_calls.get("sp2_inner0_evals", 0),
        f"sp2_inner0_evals entry calls {ZK_PATH}; launches_by_path: the same on each path",
        cuda_ms(lambda: inner0_evals(abc, z, nv, ne, F, ticket), reps), ev_pms,
        2 * S.num_cols * 32 + 3 * 32, (nv + ne) / 2,  # unreduced products: half a product
        "spartan2_tpu_torch/csrc/sumcheck.cu"))
    out[-1]["launches_by_path"] = {
        "SpartanSNARK": sc_main.get("sp2_inner0_evals", 0),
        "SpartanZkSNARK": sc_calls.get("sp2_inner0_evals", 0),
        "NeutronNovaZkSNARK": sc_nn.get("sp2_inner0_evals", 0)}
    out[-1]["device_ms"] = device_ms(sums, 10)
    out[-1]["device_ms_cold_l2"] = cold
    out.append(kernel_record(
        "inner0_bind", "spartan2_tpu/sumcheck/zk_device.py:308",
        sc_calls.get("sp2_inner0_bind", 0),
        f"sp2_inner0_bind entry calls {ZK_PATH}; launches_by_path: sp2_inner0_bind on the ZK "
        "and NN paths, sp2_inner0_bind_dev on the SpartanSNARK path (also the peeled outer "
        "round 0's bind)",
        cuda_ms(lambda: inner0_bind(a1, z1, rr, nv, ne, F), reps), bd_pms,
        2 * S.num_cols * 32 + 2 * nv * 32, 2 * nv, "spartan2_tpu_torch/csrc/sumcheck.cu"))
    out[-1]["launches_by_path"] = {
        "SpartanSNARK": sc_main.get("sp2_inner0_bind_dev", 0),
        "SpartanZkSNARK": sc_calls.get("sp2_inner0_bind", 0),
        "NeutronNovaZkSNARK": sc_nn.get("sp2_inner0_bind", 0)}
    out[-1]["device_ms"] = device_ms(lambda: inner0_bind(a1, z1, rr, nv, ne, F), 10)
    del a1, z1
    # what kernel B replaced on the non-ZK path: a quad round over abc and
    # z zero-padded to 2 num_vars (the padding itself not timed)
    padded = []
    for _ in range(reps + 2):
        a_pad, z_pad = (torch.zeros(2 * nv, 8, dtype=torch.int32, device=dev)
                        for _ in range(2))
        a_pad[: S.num_cols], z_pad[: S.num_cols] = abc[0], z[0]
        padded.append([a_pad, z_pad])
    pit = iter(padded)

    def padded_round():
        v = next(pit)
        res = round_evals_batched(QUAD, 2 * nv, v, F)
        bind(v, 2 * nv, rr, F)
        return res

    detail.append(detail_record(
        "padded quad round 0 at 2^20 (evals + bind; replaced by kernel B)",
        cuda_ms(padded_round, reps), None, 4 * nv * 32 + 2 * nv * 32, 2 * nv + 2 * nv))
    del padded, pit
    return out, detail


def _pull_ints(t: torch.Tensor, F, K: int) -> list:
    """(K, k, 8) Montgomery sums -> K lists of canonical ints."""
    from spartan2_tpu_torch.field.limbs import limbs_to_ints

    vals = limbs_to_ints(t.reshape(-1, 8), F, mont=True)
    k = len(vals) // K
    return [vals[i * k : (i + 1) * k] for i in range(K)]


def spans_by_name(spans) -> dict:
    """{span name: [calls, total ms]} of a recorded run."""
    agg: dict = {}
    for _, name, ms in spans:
        calls, total = agg.get(name, (0, 0.0))
        agg[name] = (calls + 1, total + ms)
    return {k: [c, round(t, 3)] for k, (c, t) in agg.items()}


def print_vc_commit(path: str, spans) -> None:
    """The traced prove's verifier-circuit row commits (host, C MSMs)."""
    calls, ms = spans_by_name(spans).get("vc_commit", [0, 0.0])
    if calls == 0:
        raise RuntimeError(f"{path}: the traced prove made no vc_commit")
    print(f"{path} traced prove: vc_commit {calls} calls, {ms} ms in all, "
          f"{ms / calls:.4f} ms a call", flush=True)


def kernel_group(name: str) -> str | None:
    """The redesigned kernels' group of a profiler event, if any."""
    if name.startswith("spmv_"):
        return "spmv"
    if name.startswith(("comb_points_kernel", "comb_rowsum_kernel")):
        return "comb"  # the rows; the table build (comb_bases, comb_digits) is setup's
    if name.startswith("msm_rows_kernel"):
        return "msm"  # kernels C and 5
    if name.startswith("eq_tables_kernel"):
        return "eq"
    if name.startswith("round_finish_kernel"):
        return "F"
    if any(k in name for k in ("nifs_round_kernel", "small_round_kernel", "fold_kernel")):
        return "nifs"  # NIFS kernels 3 and 4: the rounds and the folds
    if "round_kernel<" in name:
        return "A"  # kernel A's rounds, the previous bind folded in
    if "cubiceq_evals_kernel" in name:
        return "G"
    if "hyrax_bind_kernel" in name:
        return "hyrax_bind"  # kernel 4
    if name.startswith("bind_kernel"):
        return "bind"  # each sum-check's last bind, and kernel G's binds
    if name.startswith("sum_partials"):
        return "sum_partials"
    if name.startswith("reduce_pairs"):
        return "reduce_pairs"
    return None


def print_redesigned(path: str, groups: dict, dev_ms: float) -> None:
    share = {g: [ms, n, round(ms / dev_ms, 4)] for g, (ms, n) in groups.items()}
    print(f"{path} prove, redesigned kernels: SpMV, comb rows, kernel C (msm), eq "
          "tables, kernel F, kernel A's rounds and the bind, kernel G, kernel 4 "
          "(hyrax_bind), NIFS kernels 3 and 4 (device ms, launches, share of the prove's "
          f"{dev_ms:.4f} device ms): {json.dumps(share)}", flush=True)
    for gone in ("sum_partials", "reduce_pairs"):
        if gone in groups:
            raise RuntimeError(f"{path} prove launched {gone}_kernel")


def sumcheck_counts(counts: dict, want: dict, path: str) -> None:
    """A prove's kernel A / bind / F wrapper calls against the counts PERF.md
    states (the sum-checks' rounds: one F each, kernel A's first plain)."""
    got = {e: counts.get(e, 0) for e in want}
    if got != want:
        raise RuntimeError(f"{path}: sum-check launches a prove {got}, expected {want}")
    print(f"{path}: sum-check launches a prove, as expected: {json.dumps(got)}", flush=True)


def profiled_device_ms(fn) -> tuple[float, float, list, dict]:
    """(wall s, device ms, top kernels, {group: [ms, launches]} of the SpMV
    and comb rows kernels) of one run of fn under torch.profiler.  A
    warm-up step of small kernels comes first and its records are dropped
    (see ``tools/_timing.py``); only the device's own records (kernels, copies) are
    summed: a CPU op's self device time repeats its kernels', and so does
    the step's annotation on the device."""
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1)
    with torch.profiler.profile(activities=act, schedule=sched) as prof:
        x = torch.zeros(1 << 16, device="cuda")
        for _ in range(200):
            x.add_(1)
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.step()
    dev_us = sorted(((e.self_device_time_total, e.key, e.count)
                     for e in prof.key_averages()
                     if e.self_device_time_total > 0 and e.device_type != DeviceType.CPU
                     and not e.key.startswith("ProfilerStep")),
                    reverse=True)
    top = [(k[:60], round(t / 1e3, 4), c) for t, k, c in dev_us[:14]]
    groups: dict = {}
    for t, k, c in dev_us:
        g = kernel_group(k)
        if g is not None:
            ms, n = groups.get(g, [0.0, 0])
            groups[g] = [round(ms + t / 1e3, 4), n + c]
    return wall, sum(t for t, _, _ in dev_us) / 1e3, top, groups


def run_spartan(engine, circuit, dev, kernels):
    """SpartanSNARK on the main path -> (pk, prep, proof, launches)."""
    from spartan2_tpu_torch.errors import SpartanError
    from spartan2_tpu_torch.snark.spartan import SpartanSNARK
    from spartan2_tpu_torch.utils.serde import spartan_proof_to_bytes
    from spartan2_tpu_torch.utils.tracing import record

    prove_kernels = [k.name for k in kernels if k.name != "msm"]  # msm: verify only
    for k in kernels:
        k.reset()
    phases = {}
    with record() as spans_setup:
        t0 = time.perf_counter()
        pk, vk = SpartanSNARK.setup(engine, circuit, width=2048, device=dev)
        torch.cuda.synchronize()
        phases["setup_s"] = time.perf_counter() - t0
    S = pk.S
    print(f"shape: num_cons {S.num_cons} (unpadded {S.num_cons_unpadded}), "
          f"num_vars {S.num_vars}, num_cols {S.num_cols}, nnz A/B/C "
          f"{S.A.nnz}/{S.B.nnz}/{S.C.nnz}, precommitted rows "
          f"{S.num_precommitted // S.width}, rest rows {S.num_rest // S.width}",
          flush=True)
    with record() as spans_prep:
        t0 = time.perf_counter()
        prep = SpartanSNARK.prep_prove(pk, circuit, is_small=True, rng=det(1))
        torch.cuda.synchronize()
        phases["prep_prove_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof, prep = SpartanSNARK.prove(pk, circuit, prep, is_small=True, rng=det(2))
    phases["warmup_prove_s"] = time.perf_counter() - t0
    first_blob = spartan_proof_to_bytes(proof, engine)  # the mesh phase's reference
    timed = []
    sumcheck = kernels[1]
    for i in range(2):
        before = {k.name: k.launches for k in kernels}
        before_e = dict(sumcheck.entry_launches)
        t0 = time.perf_counter()
        proof, prep = SpartanSNARK.prove(pk, circuit, prep, is_small=True,
                                         rng=det(3 + i))
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
        per_prove = {k.name: k.launches - before[k.name] for k in kernels}
        sc_prove = {e: c - before_e.get(e, 0) for e, c in sumcheck.entry_launches.items()}
        eq_prove = {e: sc_prove.get(e, 0) for e in ("sp2_eq_tables", "sp2_eq_table")}
    phases["prove_s"] = timed
    # the outer sum-check's eq tables in one launch; prepare_poly_ABC's own
    if eq_prove != {"sp2_eq_tables": 1, "sp2_eq_table": 1}:
        raise RuntimeError(f"eq-table launches a SpartanSNARK prove: {eq_prove}")
    print(f"eq-table launches a SpartanSNARK prove: {json.dumps(eq_prove)} (the outer "
          "sum-check's 20 tables in one sp2_eq_tables launch)", flush=True)
    # outer: m Gruen rounds (G, F, and G's binds: round 0's peeled
    # inner0_bind_dev, then m - 1 bind_dev); inner: kernel B's round 0, then
    # mq quad rounds of kernel A (the first plain, the rest with the bind
    # folded in) and one final bind_dev; an F a round
    m, mq = S.num_cons.bit_length() - 1, S.num_vars.bit_length() - 1
    sumcheck_counts({**sc_prove, "round_finish": per_prove["round_finish"]},
                    {"sp2_round_evals": 1, "sp2_round_bind_evals": mq - 1,
                     "sp2_bind_dev": m, "sp2_inner0_bind_dev": 2, "sp2_inner0_evals": 1,
                     "sp2_bind": 0, "round_finish": m + 1 + mq}, "SpartanSNARK")
    # kernel G a Gruen round (one launch, its sums finished in it), kernel 4 once
    g4 = {"cubiceq": per_prove["cubiceq"], "hyrax_bind": per_prove["hyrax_bind"]}
    if g4 != {"cubiceq": m, "hyrax_bind": 1}:
        raise RuntimeError(f"SpartanSNARK: kernel G / 4 launches a prove {g4}, expected "
                           f"{m} / 1")
    print(f"SpartanSNARK: kernel G / 4 launches a prove, as expected: {json.dumps(g4)}",
          flush=True)
    with record() as spans_verify:
        t0 = time.perf_counter()
        if SpartanSNARK.verify(proof, vk) != circuit.public_values():
            raise RuntimeError("verify returned other public values")
        phases["verify_s"] = time.perf_counter() - t0
    launches = {k.name: k.launches for k in kernels}
    for name in launches:
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched on the main path")
    for name in prove_kernels:
        if per_prove[name] <= 0:
            raise RuntimeError(f"kernel {name} was not launched by a prove")
    inner0 = sum(kernels[1].entry_launches.get(e, 0)
                 for e in ("sp2_inner0_evals", "sp2_inner0_bind"))
    if inner0 <= 0:
        raise RuntimeError("kernel B was not launched by SpartanSNARK")

    blob = spartan_proof_to_bytes(proof, engine)
    if len(blob) != PROOF_BYTES:
        raise RuntimeError(f"proof is {len(blob)} bytes, expected {PROOF_BYTES}")
    good = list(proof.U.public_values)
    proof.U.public_values = [1 - good[0]] + good[1:]
    try:
        SpartanSNARK.verify(proof, vk)
    except SpartanError as exc:
        print(f"tampered proof rejected: {type(exc).__name__}: {exc}", flush=True)
    else:
        raise RuntimeError("tampered proof was accepted")
    proof.U.public_values = good

    # one more prove with every span synchronized, for the breakdown
    with record() as spans:
        SpartanSNARK.prove(pk, circuit, prep, is_small=True, rng=det(6))
    wall, dev_ms, top, groups = profiled_device_ms(
        lambda: SpartanSNARK.prove(pk, circuit, prep, is_small=True, rng=det(7)))
    phases["profiled_prove_s"], phases["profiled_prove_device_ms"] = wall, dev_ms
    print("prove device time by kernel (ms, launches): " + json.dumps(top), flush=True)
    print_redesigned("SpartanSNARK", groups, dev_ms)
    print("phases: " + json.dumps(phases), flush=True)
    for title, sp in (("setup", spans_setup), ("prep", spans_prep),
                      ("prove (traced)", spans), ("verify", spans_verify)):
        print(f"{title} spans ms: " + json.dumps(
            [("  " * d + n, round(ms, 3)) for d, n, ms in sp]), flush=True)
    print(f"launches per prove: {json.dumps(per_prove)}; main path: "
          f"{json.dumps(launches)}; by entry: "
          f"{json.dumps({k.name: k.entry_launches for k in kernels})}", flush=True)
    launches["sumcheck_entries"] = dict(sumcheck.entry_launches)
    launches["comb_entries"] = dict(next(k for k in kernels if k.name == "comb").entry_launches)
    if launches["comb_entries"].get("sp2_comb_build", 0) <= 0:
        raise RuntimeError("comb_build was not launched on the SpartanSNARK path")
    return pk, prep, proof, launches, first_blob


def run_spartan_zk(engine, S, circuit, dev, kernels):
    """SpartanZkSNARK on the main path, from the synthesized shape ->
    (proof, launches by kernel and entry)."""
    from spartan2_tpu_torch.errors import SpartanError
    from spartan2_tpu_torch.snark.spartan_zk import SpartanZkSNARK
    from spartan2_tpu_torch.utils.serde import (
        spartan_zk_proof_from_bytes, spartan_zk_proof_to_bytes)
    from spartan2_tpu_torch.utils.tracing import record

    for k in kernels:
        k.reset()
    phases = {}
    with record() as spans_setup:
        t0 = time.perf_counter()
        pk, vk = SpartanZkSNARK.setup_from_shape(engine, S, dev)
        torch.cuda.synchronize()
        phases["setup_from_shape_s"] = time.perf_counter() - t0
    vcs = pk.vc_shape
    print(f"verifier circuit: {vcs.num_rounds} rounds, total_vars {vcs.total_vars} "
          f"(rows of {vcs.commitment_width}), num_cons {vcs.num_cons}, num_io "
          f"{pk.vc_shape_regular.num_io}", flush=True)
    t0 = time.perf_counter()
    prep = SpartanZkSNARK.prep_prove(pk, circuit, is_small=True, rng=det(11))
    torch.cuda.synchronize()
    phases["prep_prove_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof, prep = SpartanZkSNARK.prove(pk, circuit, prep, is_small=True, rng=det(12))
    torch.cuda.synchronize()
    phases["warmup_prove_s"] = time.perf_counter() - t0
    timed = []
    for i in range(3):
        before = {k.name: dict(k.entry_launches) for k in kernels}
        t0 = time.perf_counter()
        proof, prep = SpartanZkSNARK.prove(pk, circuit, prep, is_small=True,
                                           rng=det(13 + i))
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
        per_prove = {k.name: {e: c - before[k.name].get(e, 0)
                              for e, c in k.entry_launches.items()} for k in kernels}
    phases["prove_s"] = timed
    with record() as spans_verify:
        t0 = time.perf_counter()
        if SpartanZkSNARK.verify(proof, vk) != circuit.public_values():
            raise RuntimeError("ZK verify returned other public values")
        phases["verify_s"] = time.perf_counter() - t0
    launches = {k.name: dict(k.entry_launches) for k in kernels}
    needed = {"spmv": ["sp2_spmv"], "comb": ["sp2_comb_rows"],
              "hyrax_bind": ["sp2_hyrax_bind"],
              "sumcheck": ["sp2_eq_table", "sp2_round_evals", "sp2_round_bind_evals",
                           "sp2_bind", "sp2_inner0_evals", "sp2_inner0_bind"]}
    for name, entries in needed.items():
        for e in entries:
            if per_prove[name].get(e, 0) <= 0:
                raise RuntimeError(f"{name}.{e} was not launched by a ZK prove")
    for e in ("sp2_msm", "sp2_msm_rows"):
        if launches["msm"].get(e, 0) <= 0:
            raise RuntimeError(f"msm.{e} was not launched by the ZK verify")
    # two sum-checks on kernel A (the outer cubic, m rounds; the inner quad
    # after kernel B's round 0, mq rounds): each its first round plain, the
    # rest with the bind folded in, and one final sp2_bind
    m, mq = S.num_cons.bit_length() - 1, S.num_vars.bit_length() - 1
    sumcheck_counts(per_prove["sumcheck"],
                    {"sp2_round_evals": 2, "sp2_round_bind_evals": m + mq - 2, "sp2_bind": 2,
                     "sp2_inner0_evals": 1, "sp2_inner0_bind": 1}, "SpartanZkSNARK")
    if per_prove["hyrax_bind"] != {"sp2_hyrax_bind": 1}:
        raise RuntimeError(f"SpartanZkSNARK: kernel 4 launches a prove "
                           f"{per_prove['hyrax_bind']}, expected 1")

    blob = spartan_zk_proof_to_bytes(proof, engine)
    back = spartan_zk_proof_from_bytes(blob, engine)
    if spartan_zk_proof_to_bytes(back, engine) != blob:
        raise RuntimeError("ZK proof does not round-trip through serde")
    if SpartanZkSNARK.verify(back, vk) != circuit.public_values():
        raise RuntimeError("ZK proof read back from bytes does not verify")
    print(f"ZK proof: {len(blob)} bytes, round-trips through serde and verifies",
          flush=True)
    good = back.U_verifier.challenges_per_round[0][0]
    back.U_verifier.challenges_per_round[0][0] = (good + 1) % engine.scalar.modulus
    try:
        SpartanZkSNARK.verify(back, vk)
    except SpartanError as exc:
        print(f"tampered ZK proof rejected: {type(exc).__name__}: {exc}", flush=True)
    else:
        raise RuntimeError("tampered ZK proof was accepted")

    with record() as spans:
        SpartanZkSNARK.prove(pk, circuit, prep, is_small=True, rng=det(16))
    wall, dev_ms, top, groups = profiled_device_ms(
        lambda: SpartanZkSNARK.prove(pk, circuit, prep, is_small=True, rng=det(17)))
    phases["profiled_prove_s"], phases["profiled_prove_device_ms"] = wall, dev_ms
    print("ZK prove device time by kernel (ms, launches): " + json.dumps(top), flush=True)
    print_redesigned("ZK", groups, dev_ms)
    print("ZK phases: " + json.dumps(phases), flush=True)
    print("ZK setup spans ms: " + json.dumps(spans_by_name(spans_setup)), flush=True)
    print("ZK prove (traced) spans [calls, ms]: " + json.dumps(spans_by_name(spans)),
          flush=True)
    print_vc_commit("ZK", spans)
    print("ZK verify spans [calls, ms]: " + json.dumps(spans_by_name(spans_verify)),
          flush=True)
    print(f"ZK launches per prove: {json.dumps(per_prove)}; ZK path: "
          f"{json.dumps(launches)}", flush=True)
    return proof, launches


NN_STEPS = 16
NN_TPU_PROOF_BYTES = 238021  # BENCH_NN_r04.json: the JAX package on a TPU
NN_PATH = ("on the NeutronNovaZkSNARK path: setup, prep_prove, five proves "
           "(the first fills the prep cache), verify")


def check_golden_nn(dev, name: str) -> None:
    """Prove a NeutronNova test configuration on the card from the JAX
    package's recorded keys, prep state and seed (tests/torch_golden/);
    the proof must equal the recorded JAX proof byte for byte."""
    from spartan2_tpu_torch.provider.engines import get_engine
    from spartan2_tpu_torch.snark.neutronnova import NeutronNovaZkSNARK
    from spartan2_tpu_torch.utils import serde
    from tests.torch_golden.make_golden import NN_STEPS as GOLDEN_STEPS
    from tests.torch_golden.make_golden import nn_path, read_golden
    from tests.torch_helpers import (CoreCircuit, PrecommittedStepCircuit,
                                     SquareStepCircuit)

    step = {"square": SquareStepCircuit, "precommitted": PrecommittedStepCircuit}[name]
    steps, core = [step(x) for x in GOLDEN_STEPS[name]], CoreCircuit()
    golden = read_golden(nn_path(name))
    engine = get_engine("P256HyraxEngine")
    pk, vk = serde.neutronnova_keys_from_bytes(golden["keys"], engine, device=dev)
    prep = serde.neutronnova_prep_from_bytes(golden["prep"], engine, steps, core)
    proof, _ = NeutronNovaZkSNARK.prove(pk, steps, core, prep,
                                        rng=det(golden["prove_seed"]))
    if serde.neutronnova_proof_to_bytes(proof, engine) != golden["proof"]:
        raise RuntimeError(f"NeutronNova {name}: proof on the card differs from the "
                           "JAX proof")
    want = ([c.public_values() for c in steps], core.public_values())
    if NeutronNovaZkSNARK.verify(proof, vk, len(steps)) != want:
        raise RuntimeError(f"NeutronNova {name}: proof on the card does not verify")
    print(f"NeutronNova {name} ({len(steps)} steps) on the card: proof equals the "
          f"recorded JAX proof ({len(golden['proof'])} bytes) and verifies", flush=True)


def run_neutronnova(engine, dev, kernels):
    """NeutronNovaZkSNARK on 16 SHA-256 steps (bench.py's NeutronNova
    shape) -> (pk, prep, proof, launches by kernel and entry)."""
    from spartan2_tpu_torch.errors import SpartanError
    from spartan2_tpu_torch.frontend.gadgets.sha256 import Sha256Circuit
    from spartan2_tpu_torch.snark.neutronnova import NeutronNovaZkSNARK as NN
    from spartan2_tpu_torch.utils.serde import (neutronnova_proof_from_bytes,
                                                neutronnova_proof_to_bytes)
    from spartan2_tpu_torch.utils.tracing import record

    steps = [Sha256Circuit(bytes([i] * 55)) for i in range(NN_STEPS)]
    core = Sha256Circuit(bytes(55))
    want = ([c.public_values() for c in steps], core.public_values())
    for k in kernels:
        k.reset()
    phases = {}
    with record() as spans_setup:
        t0 = time.perf_counter()
        pk, vk = NN.setup(engine, steps[0], core, NN_STEPS, width=2048, device=dev)
        torch.cuda.synchronize()
        phases["setup_s"] = time.perf_counter() - t0
    S = pk.S_step
    print(f"NN step shape: num_cons {S.num_cons} (unpadded {S.num_cons_unpadded}), "
          f"num_vars {S.num_vars}, num_cols {S.num_cols}, num_public {S.num_public}, "
          f"nnz A/B/C {S.A.nnz}/{S.B.nnz}/{S.C.nnz}, precommitted "
          f"{S.num_precommitted_unpadded} -> {S.num_precommitted} "
          f"({S.num_precommitted // S.width} rows), rest {S.num_rest_unpadded} -> "
          f"{S.num_rest}; verifier circuit {pk.vc_shape.num_rounds} rounds, "
          f"total_vars {pk.vc_shape.total_vars}", flush=True)
    with record() as spans_prep:
        t0 = time.perf_counter()
        prep = NN.prep_prove(pk, steps, core, is_small=True, rng=det(21))
        torch.cuda.synchronize()
        phases["prep_prove_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    proof, prep = NN.prove(pk, steps, core, prep, is_small=True, rng=det(22))
    torch.cuda.synchronize()
    phases["first_prove_s"] = time.perf_counter() - t0
    abc_before = prep.cache["ABC"].clone()  # filled by the first prove
    first_blob = neutronnova_proof_to_bytes(proof, engine)  # the mesh phase's reference
    t0 = time.perf_counter()
    proof, prep = NN.prove(pk, steps, core, prep, is_small=True, rng=det(23))
    torch.cuda.synchronize()
    phases["warmup_prove_s"] = time.perf_counter() - t0
    timed = []
    for i in range(3):
        before = {k.name: dict(k.entry_launches) for k in kernels}
        t0 = time.perf_counter()
        proof, prep = NN.prove(pk, steps, core, prep, is_small=True, rng=det(24 + i))
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
        per_prove = {k.name: {e: c - before[k.name].get(e, 0)
                              for e, c in k.entry_launches.items()} for k in kernels}
    phases["prove_s"] = timed
    with record() as spans_verify:
        t0 = time.perf_counter()
        if NN.verify(proof, vk, NN_STEPS) != want:
            raise RuntimeError("NN verify returned other public values")
        phases["verify_s"] = time.perf_counter() - t0
    launches = {k.name: dict(k.entry_launches) for k in kernels}
    small_ok = prep.cache["small"][1]
    grid = prep.cache["ABC"].shape
    print(f"NN small-value gate: {'passed' if small_ok else 'failed'} on the "
          f"3 x {grid[1]} x {grid[2]} grid", flush=True)
    path = {"spmv": ["sp2_spmv", "sp2_spmv_batched"], "comb": ["sp2_comb_rows"],
            "hyrax_bind": ["sp2_hyrax_bind"], "msm": ["sp2_msm_rows"],
            "sumcheck": ["sp2_pow_table", "sp2_eq_table", "sp2_round_evals",
                         "sp2_round_bind_evals", "sp2_bind", "sp2_inner0_evals",
                         "sp2_inner0_bind"],
            "nifs": ["sp2_nifs_round", "sp2_nifs_fold", "sp2_weighted_fold",
                     "sp2_nifs_to_small"] + (["sp2_nifs_small_round"] if small_ok else [])}
    for name, entries in path.items():
        for e in entries:
            if launches[name].get(e, 0) <= 0:
                raise RuntimeError(f"{name}.{e} was not launched on the NN path")
    for e in ("sp2_pow_table", "sp2_round_evals", "sp2_inner0_evals"):
        if per_prove["sumcheck"].get(e, 0) <= 0:
            raise RuntimeError(f"sumcheck.{e} was not launched by a timed NN prove")
    for e in ("sp2_nifs_round", "sp2_nifs_fold", "sp2_weighted_fold") + (
            ("sp2_nifs_small_round",) if small_ok else ()):
        if per_prove["nifs"].get(e, 0) <= 0:
            raise RuntimeError(f"nifs.{e} was not launched by a timed NN prove")
    ell_b = (NN_STEPS - 1).bit_length()
    want_nifs = {"sp2_nifs_round": ell_b - 1 if small_ok else ell_b, "sp2_nifs_fold": 1,
                 "sp2_nifs_small_round": 1 if small_ok else 0, "sp2_weighted_fold": 2,
                 "sp2_nifs_to_small": 0}
    got_nifs = {e: per_prove["nifs"].get(e, 0) for e in want_nifs}
    if got_nifs != want_nifs:
        raise RuntimeError(f"NN: NIFS launches a prove {got_nifs}, expected {want_nifs}")
    print(f"NN: NIFS launches a prove, as expected: {json.dumps(got_nifs)}", flush=True)
    m, mq = S.num_cons.bit_length() - 1, S.num_vars.bit_length() - 1
    sumcheck_counts(per_prove["sumcheck"],
                    {"sp2_round_evals": 2, "sp2_round_bind_evals": m + mq - 2, "sp2_bind": 2,
                     "sp2_inner0_evals": 1, "sp2_inner0_bind": 1}, "NeutronNovaZkSNARK")

    blob = neutronnova_proof_to_bytes(proof, engine)
    back = neutronnova_proof_from_bytes(blob, engine)
    if neutronnova_proof_to_bytes(back, engine) != blob:
        raise RuntimeError("NN proof does not round-trip through serde")
    if NN.verify(back, vk, NN_STEPS) != want:
        raise RuntimeError("NN proof read back from bytes does not verify")
    print(f"NN proof: {len(blob)} bytes (the JAX package's TPU-era run, "
          f"BENCH_NN_r04.json: {NN_TPU_PROOF_BYTES}); round-trips through serde and "
          "verifies", flush=True)
    good = list(back.step_instances[3].public_values)
    back.step_instances[3].public_values = [1 - good[0]] + good[1:]
    try:
        NN.verify(back, vk, NN_STEPS)
    except SpartanError as exc:
        print(f"tampered NN proof rejected: {type(exc).__name__}: {exc}", flush=True)
    else:
        raise RuntimeError("tampered NN proof was accepted")

    with record() as spans:
        NN.prove(pk, steps, core, prep, is_small=True, rng=det(28))
    wall, dev_ms, top, groups = profiled_device_ms(
        lambda: NN.prove(pk, steps, core, prep, is_small=True, rng=det(29)))
    phases["profiled_prove_s"], phases["profiled_prove_device_ms"] = wall, dev_ms
    phases["profiled_prove_idle_share"] = 1 - dev_ms / 1e3 / wall
    phases["proof_bytes"] = len(blob)
    print("NN prove device time by kernel (ms, launches): " + json.dumps(top), flush=True)
    print_redesigned("NN", groups, dev_ms)
    if not torch.equal(prep.cache["ABC"], abc_before):
        raise RuntimeError("NN: the proves changed the prep cache's grid")
    print("NN: the prep cache's grid is bit-identical after the timed and profiled "
          "proves", flush=True)
    print("NN phases: " + json.dumps(phases), flush=True)
    print("NN setup spans ms: " + json.dumps(spans_by_name(spans_setup)), flush=True)
    print("NN prep spans ms: " + json.dumps(spans_by_name(spans_prep)), flush=True)
    print("NN prove (traced) spans [calls, ms]: " + json.dumps(spans_by_name(spans)),
          flush=True)
    print_vc_commit("NN", spans)
    print("NN verify spans [calls, ms]: " + json.dumps(spans_by_name(spans_verify)),
          flush=True)
    print(f"NN launches per timed prove: {json.dumps(per_prove)}; NN path: "
          f"{json.dumps(launches)}", flush=True)
    return pk, prep, proof, launches, first_blob


def compare_nn_kernels(pk, prep, proof, nn_launches: dict):
    """Kernels 1-4 and kernel C at I = 16 against their plain versions, on
    the NN path's data and shapes -> (kernel records, detail records)."""
    from spartan2_tpu_torch.ec.msm import msm_rows, msm_rows_plain, msm_windows, to_jacobian
    from spartan2_tpu_torch.field.limbs import limbs_to_ints, to_device
    from spartan2_tpu_torch.pcs.hyrax import FULL_BITS
    from spartan2_tpu_torch.polys.eq import pow_generators
    from spartan2_tpu_torch.r1cs.sparse import spmv_batched, spmv_batched_plain
    from spartan2_tpu_torch.snark.neutronnova import weights_from_r
    from spartan2_tpu_torch.sumcheck.device import new_ticket, pow_table, pow_table_plain
    from spartan2_tpu_torch.sumcheck.nifs import (
        _fold_plain, nifs_fold, nifs_round, nifs_round_plain, small_round, to_small,
        weighted_fold, weighted_fold_plain)
    from spartan2_tpu_torch.field.small_value import small_round_plain, to_small_plain

    engine, S = pk.engine, pk.S_step
    curve, F = engine.curve, engine.scalar
    dev = pk.device
    gen = torch.Generator().manual_seed(3)
    rnd = random.Random(31)
    out, detail = [], []
    reps = 5
    n, m = S.num_cons, S.num_cons.bit_length() - 1
    I = NN_STEPS
    sc_calls, nifs_calls = nn_launches["sumcheck"], nn_launches["nifs"]

    def plain_ms(name, got, plain):
        want, ms = once_ms(plain)
        same_or_raise(name, got, want, F)
        return ms

    def record(name, replaces, launches, counts, ms, pms, nbytes, muls,
               source="spartan2_tpu_torch/csrc/nifs.cu"):
        out.append(kernel_record(name, replaces, launches, f"{counts} {NN_PATH}", ms, pms,
                                 nbytes, muls, source))

    # kernel 1: the power table E from 15 powers of tau; the function needs
    # n - 1 Montgomery products (the table built by doubling, as JAX does)
    gens = to_device(pow_generators(F, rnd.randrange(F.modulus), m), F, dev, mont=True)
    pms = plain_ms(f"pow_table 2^{m}", pow_table(gens, F), lambda: pow_table_plain(gens, F))
    record("pow_table", "spartan2_tpu/polys/eq.py:97",
           sc_calls.get("sp2_pow_table", 0), "sp2_pow_table entry calls",
           cuda_ms(lambda: pow_table(gens, F), reps), pms, m * 32 + n * 32,
           n - 1, "spartan2_tpu_torch/csrc/sumcheck.cu")
    out[-1]["device_ms"] = device_ms(lambda: pow_table(gens, F), reps)

    # kernel 2: Az, Bz, Cz of all 16 steps in one launch
    mats = [S.dev[k] for k in "ABC"]
    z = rand_field(I * S.num_cols, F, gen, dev).reshape(I, S.num_cols, 8)
    pms = plain_ms("spmv_batched (shape_mv_batched)", spmv_batched(mats, z, F),
                   lambda: spmv_batched_plain(mats, z, F))
    nnz = sum(mt.indices.shape[0] for mt in mats)
    record("spmv_batched", "spartan2_tpu/r1cs/shape.py:255",
           nn_launches["spmv"].get("sp2_spmv_batched", 0),
           "sp2_spmv_batched entry calls (once per prep: the first prove fills the "
           "cache)", cuda_ms(lambda: spmv_batched(mats, z, F), reps), pms,
           nnz * 36 + I * gathered(mats) * 32 + 3 * I * n * 32, I * nnz,
           "spartan2_tpu_torch/csrc/spmv.cu")

    # kernel 3: the NIFS rounds on the prep cache's real grid, which they
    # only read, each folding into a buffer of its own: t = 1 (16 -> 8, 4
    # pairs), t = 2 (8 -> 4), t = 3 (4 -> 2), then round 0 without the gate.
    # A round's wrapper pulls [e0, quad] to the host, so CUDA events include
    # that round trip; the profiler's device time is the kernel's own.  Per
    # folded pair and column: 6 bind products, 2 products and 2 unreduced
    # ones (half each, as bind_first_bound counts them)
    ABC = prep.cache["ABC"]
    abc_before = ABC.clone()
    E = pow_table(gens, F)
    tk = new_ticket(dev)  # one arrival counter, as a prove's rounds share one
    r1 = rnd.randrange(F.modulus)
    ell_b = I.bit_length() - 1
    for t, I_in in [(t, I >> (t - 1)) for t in range(1, ell_b)] + [(0, I)]:
        bind = t > 0
        pairs = (I_in // 2 if bind else I_in) // 2
        wq = rand_field(pairs, F, gen, dev)
        src = tuple(ABC[j, :I_in] for j in range(3))
        fo = want_g = None
        if bind:
            fo = torch.empty(3, I_in // 2, n, 8, dtype=torch.int32, device=dev)
            want_g = torch.empty_like(fo)
        name = (f"nifs_round t={t} ({I_in} -> {I_in // 2}, {pairs} pairs)" if bind else
                f"nifs_round t=0 (Montgomery, I={I}, {pairs} pairs; kernel 4's alternative)")
        got = nifs_round(*src, E, wq, r1, bind, F, fo, tk)
        pms = plain_ms(name, got, lambda: nifs_round_plain(*src, E, wq, r1, bind, F, want_g))
        if bind:
            same_or_raise(f"{name} folded grid", fo, want_g, F)

        def call():
            nifs_round(*src, E, wq, r1, bind, F, fo, tk)

        ms, dms = cuda_ms(call, reps), device_ms(call, reps)
        nbytes = ((3 * I_in * n * 32 + 3 * (I_in // 2) * n * 32) if bind
                  else 5 * pairs * n * 32) + n * 32 + pairs * 32 + 2 * 32
        muls = (3 * (I_in // 2) * n if bind else 0) + 3 * pairs * n
        if t == 1:
            record("nifs_round", "spartan2_tpu/sumcheck/zk_device.py:365",
                   nifs_calls.get("sp2_nifs_round", 0),
                   "sp2_nifs_round entry calls (3 a prove: rounds t = 1, 2, 3; this is "
                   "t = 1's shape, a 16-instance grid folded to 8)", ms, pms, nbytes, muls)
            out[-1]["device_ms"] = dms
        else:
            detail.append({**detail_record(name, ms, pms, nbytes, muls), "device_ms": dms})
    # the final fold 2 -> 1, into a buffer of its own
    src = tuple(ABC[j, :2] for j in range(3))
    fin = torch.empty(3, 1, n, 8, dtype=torch.int32, device=dev)
    want_f = torch.empty_like(fin)
    nifs_fold(*src, r1, F, fin)
    pms = plain_ms("nifs_fold 2 -> 1", fin,
                   lambda: (_fold_plain(src, r1, F, tuple(want_f)), want_f)[1])

    def call():
        nifs_fold(*src, r1, F, fin)

    record("nifs_final_fold", "spartan2_tpu/sumcheck/zk_device.py:459",
           nifs_calls.get("sp2_nifs_fold", 0), "sp2_nifs_fold entry calls", cuda_ms(call, reps),
           pms, 3 * 3 * n * 32, 3 * n)
    out[-1]["device_ms"] = device_ms(call, reps)
    # the witness folds, each row read where it lies: the 16 precommitted
    # prefixes x 16 weights, and W_fold + c_eval core_W; per column I
    # unreduced products and one reduction (half a product each)
    eff = S.num_shared + S.num_precommitted
    for count, width in ((I, eff), (2, S.num_vars)):
        rows = [rand_field(S.num_vars, F, gen, dev)[:width] for _ in range(count)]
        wts = to_device(weights_from_r(F, [rnd.randrange(F.modulus) for _ in range(ell_b)],
                                       I), F, dev, mont=True) if count == I else \
            rand_field(count, F, gen, dev)
        name = f"weighted_fold {count} x {width}"
        pms = plain_ms(name, weighted_fold(rows, wts, F),
                       lambda: weighted_fold_plain(torch.stack(rows), wts, F))

        def call():
            weighted_fold(rows, wts, F)

        ms, dms = cuda_ms(call, reps), device_ms(call, reps)
        nbytes, muls = count * width * 32 + count * 32 + width * 32, (count + 1) * width / 2
        if count == I:
            record("weighted_fold", "spartan2_tpu/sumcheck/zk_device.py:477",
                   nifs_calls.get("sp2_weighted_fold", 0),
                   "sp2_weighted_fold entry calls (the witness fold and W_fold + c_eval "
                   "core_W)", ms, pms, nbytes, muls)
            out[-1]["device_ms"] = dms
        else:
            detail.append({**detail_record(name, ms, pms, nbytes, muls), "device_ms": dms})
    # past 256 rows (the rows' addresses a launch takes) a call launches
    # once a chunk, each adding into the output
    rows = [rand_field(64, F, gen, dev) for _ in range(300)]
    wts = rand_field(300, F, gen, dev)
    plain_ms("weighted_fold 300 x 64 (two launches)", weighted_fold(rows, wts, F),
             lambda: weighted_fold_plain(torch.stack(rows), wts, F))
    if not torch.equal(ABC, abc_before):
        raise RuntimeError("nifs: the rounds changed the prep cache's grid")

    # kernel 4: the gate over the real grid, then round 0 on small integers;
    # each from_mont is a lone reduction, half a Montgomery product
    S_small, ok = to_small(ABC[0], ABC[1], ABC[2], F)
    pl = [to_small_plain(ABC[j], F) for j in range(3)]
    want_ok = all(bool(o.all()) for _, o in pl)
    if ok != want_ok:
        raise RuntimeError("nifs_to_small: gate differs from its plain version")
    pms = plain_ms("nifs_to_small", S_small,
                   lambda: torch.stack([to_small_plain(ABC[j], F)[0] for j in range(3)]))
    record("nifs_to_small", "spartan2_tpu/sumcheck/zk_device.py:387",
           nifs_calls.get("sp2_nifs_to_small", 0),
           "sp2_nifs_to_small entry calls (once per prep)",
           cuda_ms(lambda: to_small(ABC[0], ABC[1], ABC[2], F), reps), pms,
           3 * I * n * 32 + 3 * I * n * 16, 3 * I * n / 2)
    w8 = rand_field(I // 2, F, gen, dev)
    got = small_round(S_small, E, w8, F, tk)
    pms = plain_ms(f"nifs_small_round (I={I}, {I // 2} pairs)", got,
                   lambda: limbs_to_ints(small_round_plain(S_small, E, w8, F), F))
    mont = nifs_round(ABC[0], ABC[1], ABC[2], E, w8, 0, False, F)  # no fold: no write
    if ok and got != mont:
        raise RuntimeError("nifs_small_round differs from the Montgomery round 0")
    print(f"small round 0 {'equals' if ok else '(gate failed; not compared with)'} the "
          "Montgomery round 0", flush=True)

    def call():
        small_round(S_small, E, w8, F, tk)

    # per pair entry: 9 + 9 products of 32-bit words for the two integer
    # products, 2 x 40 for the multiples of E; 2 multiply-adds each
    record("nifs_small_round", "spartan2_tpu/sumcheck/zk_device.py:445",
           nifs_calls.get("sp2_nifs_small_round", 0),
           "sp2_nifs_small_round entry calls", cuda_ms(call, reps), pms,
           5 * (I // 2) * n * 16 + n * 32, (I // 2) * n * 196 / IMAD_PER_MONT_MUL)
    out[-1]["device_ms"] = device_ms(call, reps)

    # kernel C at R = 15, I = 16: the prover's fold of the steps'
    # precommitted rows with this run's points
    rows = [U.comm_W_precommitted.comm for U in proof.step_instances]
    R = len(rows[0])
    wts = weights_from_r(F, [rnd.randrange(F.modulus) for _ in range(ell_b)], I)
    sc = to_device(wts, F, dev).expand(R, I, 8).contiguous()
    pts = to_jacobian([rows[i][r] for r in range(R) for i in range(I)], curve,
                      dev).reshape(R, I, 3, 8)
    want, pms = host_plain(lambda s_, p_: msm_rows_plain(s_, p_, curve), sc, pts)
    same_or_raise(f"msm_rows R={R} I={I}", msm_rows(sc, pts, curve).cpu(), want, F)
    record("msm_rows_nn", "spartan2_tpu/ec/device.py:424",
           nn_launches["msm"].get("sp2_msm_rows", 0),
           "sp2_msm_rows entry calls (the folds of the step commitments in prove "
           "and verify)", cuda_ms(lambda: msm_rows(sc, pts, curve), reps), pms,
           R * I * (32 + 96) + R * 96, msm_point_ops(sc, msm_windows(FULL_BITS), curve),
           "spartan2_tpu_torch/csrc/msm.cu")
    return out, detail

KECCAK_LENGTHS = (0, 1, 135, 136, 137, 271, 272, 1000)


def keccak_blocks(n_bytes: int) -> int:
    """Keccak-f[1600] permutations that Keccak-256 of n_bytes needs."""
    return n_bytes // 136 + 1


def check_transcript(dev, launches: dict):
    """(a) kernel T's Keccak against the host's, (b) a DeviceTranscript
    sequence against the host Transcript; -> (kernel records, details)."""
    import numpy as np

    from spartan2_tpu_torch.field.limbs import limbs_to_ints, to_device
    from spartan2_tpu_torch.provider.engines import get_engine
    from spartan2_tpu_torch.transcript.device import (
        DeviceTranscript, fe_bytes, host_bytes, keccak256_batch, keccak256_batch_plain,
        squeeze, squeeze_plain)
    from spartan2_tpu_torch.transcript.keccak import keccak256
    from spartan2_tpu_torch.transcript.transcript import Transcript

    F = get_engine("P256HyraxEngine").scalar
    rng = np.random.default_rng(7)
    detail = []
    for L in KECCAK_LENGTHS:  # (a)
        msgs = torch.from_numpy(rng.integers(0, 256, size=(64, L), dtype=np.uint8))
        got = keccak256_batch(msgs.to(dev)).cpu()
        want = torch.tensor([list(keccak256(m.numpy().tobytes())) for m in msgs],
                            dtype=torch.uint8)
        if not torch.equal(got, want):
            raise RuntimeError(f"sp2_keccak256 differs from the host Keccak at {L} bytes")
    print(f"(a) sp2_keccak256 equals the host Keccak on 64 messages at each of "
          f"{list(KECCAK_LENGTHS)} bytes", flush=True)
    msgs = torch.from_numpy(rng.integers(0, 256, size=(64, 1000), dtype=np.uint8)).to(dev)
    pms = once_ms(lambda: keccak256_batch_plain(msgs.cpu()))[1]
    detail.append(detail_record("keccak256 batch 64 x 1000 bytes (one thread a message)",
                                cuda_ms(lambda: keccak256_batch(msgs), 10), pms,
                                64 * (1000 + 32), 0, 64 * keccak_blocks(1000) * KECCAK_F_OPS))
    # latency floors of the one-block kernels (T's squeeze, F): a launch
    # with one thread of work, and one thread's chain of 2 permutations
    # (a round's 169-byte squeeze input is 2 blocks)
    one = to_device([1], F, dev, mont=True)
    detail.append(detail_record("launch floor: sp2_fe_bytes of one element",
                                cuda_ms(lambda: fe_bytes(one, F, True), 100), None, 64, 0.5))
    m169 = msgs[:1, :169].contiguous()
    detail.append(detail_record("keccak256 of one 169-byte message (2 permutations)",
                                cuda_ms(lambda: keccak256_batch(m169), 100), None, 201, 0,
                                2 * KECCAK_F_OPS))

    # (b) the same absorbs and squeezes on the card and on the host
    vals = [random.Random(60 + i).randrange(F.modulus) for i in range(5)]
    a = to_device(vals, F, dev, mont=True)
    host = Transcript(F, b"SpartanSNARK")
    td = DeviceTranscript(F, b"SpartanSNARK", device=dev)
    for t in (host, td):
        t.absorb_bytes(b"vk", bytes(range(32)))
    host.absorb_scalars(b"vals", vals)
    td.absorb_scalars_mont(b"vals", a)
    host.absorb_scalar(b"one", vals[2])
    td.absorb_scalar_mont(b"one", a[2])
    for i in range(3):
        if i == 1:
            host.dom_sep(b"phase2")
            td.dom_sep(b"phase2")
        if host.squeeze(b"c") != limbs_to_ints(td.squeeze_mont(b"c"), F, mont=True)[0]:
            raise RuntimeError("DeviceTranscript squeeze differs from the host's")
    back = Transcript(F, b"other")
    td.to_host(back)
    if (back.state, back.round) != (host.state, host.round):
        raise RuntimeError("DeviceTranscript hand-off to the host differs")
    for t in (back, host):
        t.absorb_bytes(b"x", b"123")
    if back.squeeze(b"r") != host.squeeze(b"r"):
        raise RuntimeError("host transcript after the hand-off differs")
    td = DeviceTranscript.from_host(back, dev)
    if td.squeeze_bytes(b"s").cpu().numpy().tobytes() != host.squeeze_bytes(b"s"):
        raise RuntimeError("DeviceTranscript hand-off from the host differs")
    print("(b) DeviceTranscript on the card equals the host Transcript: 3 squeezes, "
          "hand-off both ways", flush=True)

    # kernel T as the main path runs it: the claims_outer absorb of three
    # finals and the squeeze of r (DeviceTranscript in SpartanSNARK.prove)
    fin = to_device(vals[:3], F, dev, mont=True)
    state = td.state.clone()
    label = b"claims_outer"

    def claims_r():
        buf = torch.cat([host_bytes(label, dev), fe_bytes(fin, F, True).reshape(-1)])
        return squeeze(buf, 7, state, b"r", F)

    got = claims_r()
    fin_cpu, st_cpu = fin.cpu(), state.cpu()

    def plain():
        buf = torch.cat([host_bytes(label, "cpu"), fe_bytes(fin_cpu, F, True).reshape(-1)])
        return squeeze_plain(buf, 7, st_cpu, b"r", F)

    want, pms = once_ms(plain)
    if not (torch.equal(got[0].cpu(), want[0]) and torch.equal(got[1].cpu(), want[1])):
        raise RuntimeError("kernel T (fe_bytes + squeeze) differs from its plain version")
    print("equal to plain: transcript (fe_bytes + squeeze, claims_outer and r)", flush=True)
    msg_len = len(label) + 96 + 4 + 2 + 64 + 1
    records = [kernel_record(
        "transcript", "spartan2_tpu/transcript/device.py:133", launches["transcript"],
        NONZK_COUNTS + " (sp2_fe_bytes and sp2_squeeze: the claims_outer absorb and "
        "the squeeze of r, 2 per prove; the permutation also runs inside every "
        "round_finish)", cuda_ms(claims_r, 20), pms,
        # 3 from_mont (half a product each) and from_uniform (2 products)
        3 * 32 + 64 + 64 + 32, 3 / 2 + 2, source="spartan2_tpu_torch/csrc/transcript.cu",
        int_ops=2 * keccak_blocks(msg_len + 1) * KECCAK_F_OPS)]
    return records, detail


def _clone(t):
    c = copy.copy(t)
    c.buf = bytearray(t.buf)
    return c


def _timed(fn):
    """(result, host ms) of fn() ended by a device synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    return res, (time.perf_counter() - t0) * 1e3


def _no_sync(fn):
    """fn() with any host synchronization an error (the rounds' claim)."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _compressed(coeffs, F):
    from spartan2_tpu_torch.field.limbs import limbs_to_ints

    k = coeffs.shape[1]
    v = limbs_to_ints(coeffs.reshape(-1, 8), F, mont=True)
    return [[v[k * j]] + v[k * j + 2 : k * j + k] for j in range(coeffs.shape[0])]


def check_sumchecks(pk, prep, circuit, launches: dict, probe, expect_peeled: bool = True):
    """(c)-(e): the device-transcript sum-checks against the host-challenge
    drivers and their plain versions; kernels F and G against their plain
    versions at the main path's shapes -> (kernel records, details)."""
    from spartan2_tpu_torch.field.limbs import limbs_to_ints, to_device
    from spartan2_tpu_torch.snark.spartan import SpartanSNARK
    from spartan2_tpu_torch.sumcheck.device import (
        CUBIC, DOT, cubiceq_evals, cubiceq_evals_plain, eq_factors, eq_table, new_ticket,
        round_evals, round_sums)
    from spartan2_tpu_torch.sumcheck.prove import (
        _NCOEFFS, CUBIC_EVALS, GRUEN, INNER0, QUAD_EVALS, SumcheckProverCubic,
        SumcheckProverCubicEq, challenge, prove_cubic_eq, prove_quad, round_finish)
    from tools.round_latency import F_DEPTH, F_PERMUTATIONS, f_latency_floor
    from spartan2_tpu_torch.sumcheck.zk_device import inner_round0
    from spartan2_tpu_torch.transcript.device import DeviceTranscript
    from spartan2_tpu_torch.transcript.transcript import Transcript

    engine, S = pk.engine, pk.S
    F = engine.scalar
    p = F.modulus
    dev = pk.device
    with torch.inference_mode():
        transcript, U, W, z, taus, ABC = SpartanSNARK.instance(pk, circuit, prep, True,
                                                               det(40))
    m, eff = len(taus), S.num_cons_unpadded
    peeled = 1 << (m - 1) < eff < 1 << m  # round 0 reads the upper half below eff
    if peeled != expect_peeled:
        raise RuntimeError(f"outer sum-check path: peeled {peeled}, expected {expect_peeled}")
    phases = {}

    # (c) the outer sum-check: the host-challenge driver and the prove's,
    # each on its own copies; the device driver's rounds under sync debug
    def outer_host():
        t, v = _clone(transcript), ABC.clone()
        return prove_cubic_eq(t, taus, v[0], v[1], v[2], F), t

    def outer_device(pull=False):
        td, v = DeviceTranscript.from_host(transcript, dev), ABC.clone()
        out = _no_sync(lambda: SpartanSNARK.outer_sumcheck(F, td, v, taus, eff))
        return (tuple(x.cpu() for x in (out[0], out[1], torch.stack(out[2]), td.state))
                if pull else (out, td))

    (proof_h, rx_h, fin_h), t_host = outer_host()
    (coeffs, rx_pairs, fin), td = outer_device()
    if (_compressed(coeffs, F) != [c.coeffs_except_linear for c in proof_h.compressed_polys]
            or limbs_to_ints(rx_pairs[:, 0], F, mont=True) != rx_h
            or limbs_to_ints(torch.stack(fin), F, mont=True) != fin_h
            or td.state.cpu().numpy().tobytes() != t_host.state
            or td.round != t_host.round):
        raise RuntimeError("(c) the device-transcript outer sum-check differs from the "
                           "host-challenge driver")

    # (d) inner round 0 and the quad rounds over num_vars, from (c)'s state
    nv, ne = S.num_vars, S.num_cols - S.num_vars
    abc = S.bind_and_prepare_poly_ABC(rx_h, random.Random(41).randrange(p))
    claim = round_evals(DOT, S.num_cols, [abc, z], F)[0]
    claim_dev = to_device([claim], F, dev, mont=True)[0]

    def inner_host():
        t, a, zz = _clone(t_host), abc.clone(), z.clone()
        r0, (poly0,), (claim0,) = inner_round0(F, [claim], a, zz, nv, ne,
                                               lambda unis: challenge(t, unis[0]))
        proof, rs, finals = prove_quad(t, claim0, a[:nv], zz[:nv], F)
        return ([poly0.compress()] + proof.compressed_polys, [r0] + rs, finals), t

    def inner_device(pull=False):
        td, a, zz = DeviceTranscript.from_host(t_host, dev), abc.clone(), z.clone()
        out = _no_sync(lambda: SpartanSNARK.inner_sumcheck(F, td, a, zz, claim_dev, nv, ne))
        return tuple(x.cpu() for x in (*out, td.state)) if pull else (out, td)

    (polys_h, ry_h, fin_i), t_host2 = inner_host()
    (ci, ry_pairs, ez), td2 = inner_device()
    if (_compressed(ci, F) != [c.coeffs_except_linear for c in polys_h]
            or limbs_to_ints(ry_pairs[:, 0], F, mont=True) != ry_h
            or limbs_to_ints(ez, F, mont=True)[0] != fin_i[1]
            or td2.state.cpu().numpy().tobytes() != t_host2.state):
        raise RuntimeError("(d) the device-transcript inner sum-check differs from the "
                           "host-challenge driver")
    # end to end, each ended by its results on the host, in turns
    for name, host_fn, dev_fn in (("outer", outer_host, outer_device),
                                  ("inner", inner_host, inner_device)):
        for rep in range(3):
            for kind, fn in (("host", host_fn), ("device", lambda: dev_fn(pull=True)))[
                    ::1 if rep % 2 == 0 else -1]:
                phases.setdefault(f"{name}_{kind}_driver_ms", []).append(_timed(fn)[1])
    print(f"(c) outer sum-check 2^{m} ({'peeled, ' if peeled else ''}zero_check), "
          f"{m} rounds, no host sync before the pull: equal to the host-challenge driver "
          "(coefficients, r_x, finals, state)", flush=True)
    print(f"(d) inner round 0 over {S.num_cols} and {len(ry_h) - 1} quad rounds over "
          f"{nv}, no host sync before the pull: equal to the host-challenge driver",
          flush=True)

    # (e) the Gruen prover at m = 12 with tau_0 = 0, tau_1 = 1, and the
    # explicit-eq cubic prover (kernel A CUBIC, F's CUBIC_EVALS mode)
    gen = torch.Generator().manual_seed(12)
    me = 12
    taus_e = [0, 1] + [random.Random(70 + j).randrange(p) for j in range(me - 2)]
    vecs = [rand_field(1 << me, F, gen, "cpu") for _ in range(3)]
    for name, run in (
            ("Gruen prover, m = 12, tau_0 = 0, tau_1 = 1",
             lambda td, v, zero: SumcheckProverCubicEq(F).prove(td, *v, zero, taus_e)),
            ("explicit-eq cubic prover, m = 12",
             lambda td, v, zero: SumcheckProverCubic(F).prove(
                 td, eq_table(eq_factors(taus_e, F, zero.device), F), *v, zero))):
        outs = []
        for d in (dev, "cpu"):
            tde = DeviceTranscript.from_host(Transcript(F, b"gruen"), d)
            v = [x.clone().to(d) for x in vecs]
            c, rs, fe, cl = run(tde, v, torch.zeros(8, dtype=torch.int32, device=d))
            outs.append([c.cpu(), rs.cpu(), torch.stack(fe).cpu(), cl.cpu(),
                         tde.state.cpu()])
        if not all(torch.equal(x, y) for x, y in zip(*outs)):
            raise RuntimeError(f"(e) {name}: the card differs from the plain version")
        print(f"(e) {name}: the card equals the plain version (coefficients, "
              "challenges, finals, claim, state)", flush=True)
    print("sum-check drivers (host ms): " + json.dumps(phases), flush=True)

    # kernel G at the peeled round 0's shape and at round 1's (two-level)
    out, detail = [], []
    fh = m // 2
    R, L0, half = 1 << (m - fh), 1 << (fh - 1), 1 << (m - 1)
    hi_len = eff - half  # the upper half's rows below eff
    from spartan2_tpu_torch.polys.eq import eq_evals_host
    EL = to_device(eq_evals_host(F, taus[1:fh]), F, dev, mont=True)
    ER = to_device(eq_evals_host(F, taus[fh:]), F, dev, mont=True)
    A, B, C = ABC[0], ABC[1], ABC[2]

    def g_case(name, args, zc):
        got = cubiceq_evals(A, B, C, *args, zc, False, F)
        want, pms = once_ms(lambda: cubiceq_evals_plain(A, B, C, *args, zc, False, F))
        gs = [sum(col) % p for col in zip(*[limbs_to_ints(b, F, mont=True)
                                            for b in got.cpu()])]
        if gs != limbs_to_ints(want[0], F, mont=True):
            raise RuntimeError(f"kernel G ({name}) differs from its plain version")
        print(f"equal to plain: cubiceq_evals ({name})", flush=True)
        return got, pms

    peel_args = (half, hi_len, EL, ER, m - fh)
    part, pms = g_case(f"peeled round 0, 2^{m}, upper half read below {hi_len} of {half}",
                       peel_args, True)
    ticket = new_ticket(dev)  # one a sum-check, as the prove passes it

    def peel():
        cubiceq_evals(A, B, C, *peel_args, True, False, F, ticket=ticket)

    # zero_check: A, B lower half, their live upper rows; tinf alone
    rec = kernel_record(
        "cubiceq", "spartan2_tpu/sumcheck/fused.py:307", launches["cubiceq"],
        NONZK_COUNTS + " (one sp2_cubiceq_evals per outer round)", cuda_ms(peel, 10), pms,
        2 * (half + hi_len) * 32 + (L0 + R) * 32 + 3 * 32 * part.shape[0],
        g_muls(half, 1 << (m - fh), 1), source="spartan2_tpu_torch/csrc/cubiceq.cu")
    rec["device_ms"] = device_ms(peel, 10)
    out.append(rec)
    r1_args = (half // 2, half // 2, EL, ER, m - fh)
    _, pms1 = g_case(f"round 1, 2^{m - 1}, two-level", r1_args, False)

    def r1():
        cubiceq_evals(A, B, C, *r1_args, False, False, F, ticket=ticket)

    detail.append({**detail_record(
        f"cubiceq_evals round 1 2^{m - 1} (t0 and tinf, two-level)", cuda_ms(r1, 10), pms1,
        3 * half * 32 + (L0 + R) * 32, g_muls(half // 2, 1 << (m - fh), 2)),
        "device_ms": device_ms(r1, 10)})

    # kernel F in every mode against its plain version: the Gruen modes on
    # kernel G's sums of the peeled round 0 (zero_check, as the
    # prove runs it) and of round 1 (plain, and with fallback: tau = 0),
    # CUBIC_EVALS on kernel A's sums at 2^m, QUAD and INNER0 on random sums
    eqt = eq_table(eq_factors(taus, F, dev), F)
    part_c = round_sums(CUBIC, 1 << m, [eqt, A, B, C], F)
    gen_f = torch.Generator().manual_seed(44)
    part_r1 = cubiceq_evals(A, B, C, *r1_args, False, True, F)

    def gruen_consts(t):
        return to_device([(1 - t) % p, (2 * t - 1) % p, (2 - 3 * t) % p,
                          pow(t, -1, p) if t else 0], F, dev, mont=True)

    ctx = torch.cat([to_device([0, 1], F, dev, mont=True),
                     td.state.view(torch.int32).reshape(2, 8)])
    ctx_r = torch.cat([to_device([random.Random(43).randrange(p),
                                  random.Random(45).randrange(p)], F, dev, mont=True),
                       td.state.view(torch.int32).reshape(2, 8)])
    consts = gruen_consts(taus[0])
    f_cases = [
        ("gruen, zero_check (peeled round 0)", GRUEN, part, ctx, consts, True, False),
        ("gruen (round 1's sums)", GRUEN, part_r1, ctx_r, gruen_consts(taus[1]), False,
         False),
        ("gruen, fallback (tau = 0)", GRUEN, part_r1, ctx_r, gruen_consts(0), False, True),
        (f"cubic evals (kernel A CUBIC at 2^{m})", CUBIC_EVALS, part_c, ctx_r, None, False,
         False),
        ("quad", QUAD_EVALS, rand_field(2, F, gen_f, dev).reshape(1, 2, 8), ctx_r, None,
         False, False),
        ("inner0", INNER0, rand_field(3, F, gen_f, dev).reshape(1, 3, 8), ctx_r, None, False,
         False)]
    f_ms = {}
    for name, mode, sums, cx, cs, zc, fb in f_cases:
        slots = [torch.empty(_NCOEFFS[mode], 8, dtype=torch.int32, device=dev),
                 torch.empty(2, 8, dtype=torch.int32, device=dev)]
        ctx_k = cx.clone()
        round_finish(mode, sums, ctx_k, *slots, 9, F, cs, zc, fb)
        cpu = [t.cpu() for t in (sums, cx)]
        cslots = [torch.empty_like(t, device="cpu") for t in slots]
        cs_cpu = None if cs is None else cs.cpu()
        _, pms = once_ms(lambda: round_finish(mode, cpu[0], cpu[1], *cslots, 9, F, cs_cpu,
                                              zc, fb))
        if not (torch.equal(ctx_k.cpu(), cpu[1]) and all(
                torch.equal(a.cpu(), b) for a, b in zip(slots, cslots))):
            raise RuntimeError(f"kernel F ({name}) differs from its plain version")
        ctxs = iter([cx.clone() for _ in range(43)])

        def f_run():
            round_finish(mode, sums, next(ctxs), *slots, 9, F, cs, zc, fb)

        f_ms[name] = {"ms": cuda_ms(f_run, 20), "device_ms": device_ms(f_run, 20),
                      "plain_ms": pms, "rows": sums.shape[0]}
        print(f"equal to plain: round_finish ({name}, {sums.shape[0]} rows of sums)",
              flush=True)
    floor = f_latency_floor(probe, F, "gruen")
    print(f"kernel F latency floor (Gruen): {F_DEPTH['gruen']} products in sequence at "
          f"{floor['mul_cc_us']:.4f} us (fe_mul_cc) and {F_PERMUTATIONS} warp-wide "
          f"permutations at {floor['permutation_us']:.4f} us: "
          f"{floor['latency_floor_ms']:.5f} ms; by mode (ms a launch, CUDA events / device): "
          + json.dumps(f_ms), flush=True)
    msg_len = 1 + 3 * 32 + 4 + 2 + 64 + 1
    peel = f_ms[f_cases[0][0]]
    rec = kernel_record(
        "round_finish", "spartan2_tpu/sumcheck/prove.py:188", launches["round_finish"],
        NONZK_COUNTS + " (one sp2_round_finish per sum-check round, outer and inner)",
        peel["ms"], peel["plain_ms"],
        # Gruen algebra 7 products, 3 from_mont, from_uniform 2, Horner 3, P 2
        part.numel() * 4 + 4 * 32 + 5 * 32 + 4 * 32 + 2 * 32 + 4 * 32, 15.5,
        source="spartan2_tpu_torch/csrc/round_finish.cu",
        int_ops=2 * keccak_blocks(msg_len + 1) * KECCAK_F_OPS)
    rec.update({"latency_floor_ms": floor["latency_floor_ms"], "device_ms": peel["device_ms"],
                "mul_cc_us": floor["mul_cc_us"], "permutation_us": floor["permutation_us"]})
    out.append(rec)
    for name, rec_f in f_ms.items():
        if name != f_cases[0][0]:
            detail.append({"name": f"round_finish {name}", **rec_f})
    detail.append({"name": "keccak_f1600 one warp (us)", "us": floor["permutation_us"]})
    return out, detail



def _capture(body, refill) -> "torch.cuda.CUDAGraph":
    """body() captured in a CUDA graph after a warm-up run on a side stream;
    refill() sets the captured buffers' inputs first.  A host
    synchronization or a pageable copy inside body() fails the capture."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        refill()
        body()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    refill()
    torch.cuda.synchronize()
    with torch.cuda.graph(graph):
        body()
    torch.cuda.synchronize()
    return graph


def check_graphs(pk, prep, circuit) -> list:
    """The enqueued outer and inner sum-checks at SHA-256 1 KiB's 2^20,
    on kernels F, G, A and B, each captured whole in a torch.cuda.CUDAGraph
    (their rounds, with the plan, eq tables and context uploaded before):
    the capture proves that no round synchronizes with the host.  The
    graph is replayed on two sets of fresh inputs copied into its buffers
    (Az/Bz/Cz random below eff and zero past it, abc and z random, a
    random transcript state and claim), each against an uncaptured run of
    the prove's own sum-check (SpartanSNARK.outer_sumcheck,
    inner_sumcheck) on the same inputs: coefficients, challenges, finals
    and transcript state equal -> detail records (replay and enqueue ms)."""
    from spartan2_tpu_torch.field.limbs import to_device
    from spartan2_tpu_torch.snark.spartan import SpartanSNARK
    from spartan2_tpu_torch.sumcheck.device import inner0_bind_dev, inner0_sums
    from spartan2_tpu_torch.sumcheck.prove import (
        INNER0, SumcheckProverCubicEq, SumcheckProverQuad, round_finish)
    from spartan2_tpu_torch.transcript.device import DeviceTranscript

    inp = _sumcheck_inputs(pk, prep, circuit)
    F, dev = pk.engine.scalar, pk.device
    p = F.modulus
    taus, eff, nv, ne = inp["taus"], inp["eff"], inp["nv"], inp["ne"]
    m, mq = len(taus), nv.bit_length() - 1
    n = 1 << m
    i32 = torch.int32

    def fresh_state(seed):
        rb = random.Random(seed)
        return torch.tensor([rb.randrange(256) for _ in range(64)], dtype=torch.uint8,
                            device=dev)

    def ctx_of(claim, state):
        return torch.cat([to_device([claim, 1], F, dev, mont=True),
                          state.view(i32).reshape(2, 8)])

    # the outer sum-check: m Gruen rounds (G, F, G's binds)
    prover = SumcheckProverCubicEq(F)
    plan = prover.plan(taus, True, dev)
    hi = prover.upper_live(n, eff)
    r_out = inp["t_outer"][1]
    o = {"v": torch.empty(3, n, 8, dtype=i32, device=dev),
         "ctx": torch.empty(4, 8, dtype=i32, device=dev),
         "coeffs": torch.empty(m, 4, 8, dtype=i32, device=dev),
         "rs": torch.empty(m, 2, 8, dtype=i32, device=dev)}
    o_in = {}

    def outer_body():
        v = o["v"]
        prover.rounds(plan, o["ctx"], o["coeffs"], o["rs"], r_out, [v[0], v[1], v[2]], n,
                      0, m, hi)

    def outer_refill():
        o["v"].copy_(o_in["v"])
        o["ctx"].copy_(o_in["ctx"])

    def outer_inputs(seed):
        gen = torch.Generator().manual_seed(seed)
        v = rand_field(3 * n, F, gen, dev).reshape(3, n, 8)
        v[:, eff:] = 0
        return {"v": v, "ctx": ctx_of(0, fresh_state(seed)), "state": fresh_state(seed)}

    o_in.update(outer_inputs(50))
    outer_graph = _capture(outer_body, outer_refill)

    # the inner sum-check: kernel B's round 0 (its sums, F, its bind), then
    # mq quad rounds of kernel A and F, and the last bind
    quad = SumcheckProverQuad(F)
    r_in = inp["t_inner"][1]
    rows = inp["abc"].shape[0]
    q = {"abc": torch.empty(rows, 8, dtype=i32, device=dev),
         "z": torch.empty(inp["z"].shape[0], 8, dtype=i32, device=dev),
         "ctx": torch.empty(4, 8, dtype=i32, device=dev),
         "coeffs": torch.empty(1 + mq, 3, 8, dtype=i32, device=dev),
         "rs": torch.empty(1 + mq, 2, 8, dtype=i32, device=dev)}
    q_in = {}

    def inner_body():
        abc, z = q["abc"], q["z"]
        sums = inner0_sums(abc, z, nv, ne, F)
        round_finish(INNER0, sums, q["ctx"], q["coeffs"][0], q["rs"][0], r_in, F)
        inner0_bind_dev([abc, z], q["rs"][0], nv, ne, F)
        quad.rounds(q["ctx"], q["coeffs"][1:], q["rs"][1:], r_in + 1, [abc[:nv], z[:nv]],
                    nv, 0, mq)

    def inner_refill():
        for k in ("abc", "z", "ctx"):
            q[k].copy_(q_in[k])

    def inner_inputs(seed):
        gen = torch.Generator().manual_seed(seed)
        abc = rand_field(rows, F, gen, dev)
        z = rand_field(q["z"].shape[0], F, gen, dev)
        abc[nv + ne:] = 0
        z[nv + ne:] = 0
        claim = random.Random(seed).randrange(p)
        return {"abc": abc, "z": z, "claim": claim, "state": fresh_state(seed + 1),
                "ctx": ctx_of(claim, fresh_state(seed + 1))}

    q_in.update(inner_inputs(60))
    inner_graph = _capture(inner_body, inner_refill)

    detail = []
    for seed in (51, 52):
        o_in.update(outer_inputs(seed))
        outer_refill()
        _, replay_ms = _timed(outer_graph.replay)
        td = DeviceTranscript(F, state=o_in["state"].clone(), round=r_out)
        (c, rx, fin), enq_ms = _timed(lambda: SpartanSNARK.outer_sumcheck(
            F, td, o_in["v"].clone(), taus, eff))
        v = o["v"]
        if not (torch.equal(o["coeffs"], c) and torch.equal(o["rs"], rx)
                and torch.equal(torch.stack([v[0][0], v[1][0], v[2][0]]), torch.stack(fin))
                and torch.equal(o["ctx"][2:].reshape(-1).view(torch.uint8), td.state)):
            raise RuntimeError("the outer sum-check's CUDA graph differs from the "
                               "uncaptured run")
        q_in.update(inner_inputs(seed + 10))
        inner_refill()
        _, inner_replay_ms = _timed(inner_graph.replay)
        td = DeviceTranscript(F, state=q_in["state"].clone(), round=r_in)
        claim = to_device([q_in["claim"]], F, dev, mont=True)[0]
        (ci, ry, ez), inner_enq_ms = _timed(lambda: SpartanSNARK.inner_sumcheck(
            F, td, q_in["abc"].clone(), q_in["z"].clone(), claim, nv, ne))
        if not (torch.equal(q["coeffs"], ci) and torch.equal(q["rs"], ry)
                and torch.equal(q["z"][0], ez)
                and torch.equal(q["ctx"][2:].reshape(-1).view(torch.uint8), td.state)):
            raise RuntimeError("the inner sum-check's CUDA graph differs from the "
                               "uncaptured run")
        detail.append({"name": f"CUDA graphs, inputs {seed}", "outer_replay_ms": replay_ms,
                       "outer_enqueued_ms": enq_ms, "inner_replay_ms": inner_replay_ms,
                       "inner_enqueued_ms": inner_enq_ms})
    print(f"CUDA graphs: the enqueued outer sum-check (2^{m}, {m} rounds) and inner "
          f"sum-check (round 0 and {mq} quad rounds) captured whole, no host "
          "synchronization; replayed on two sets of fresh inputs, equal to uncaptured runs "
          "(coefficients, challenges, finals, state): " + json.dumps(detail), flush=True)
    return detail


G_CASE_M = 14  # rows of kernel G's mode cases: 2^14


def zero_stack_or_raise(kernel) -> list:
    """Every kernel of ``kernel``'s library built with 0 bytes of stack
    frame and of spills (its ptxas lines) -> those lines."""
    log = kernel.lib_path.parent / f"{kernel.name}.log"
    lines = [ln.strip() for ln in log.read_text().splitlines() if "stack frame" in ln]
    if not lines or any(not ln.startswith(
            "0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads") for ln in lines):
        raise RuntimeError(f"{kernel.name}: stack or spills in its ptxas lines: {lines}")
    return lines


def check_g_and_bind(dev) -> list:
    """Kernels G and 4 against their plain versions on P-256 and Pallas.
    G at the main path's round 0 (peeled: the upper half read below its
    live rows) and round 1 over 2^20 rows, then over 2^14 rows in every
    mode: two-level (left rows of 128, 8 and, at lw = 2 > rlog = 1, 1
    pair) and one-level, zero_check on and off, fallback on, hi_len 0,
    some and half, the shard stride at lw = 1 and 2 with shard != 0, on
    random inputs, all zeros and all p - 1; every case launched twice on
    one ticket.  Kernel 4 at 256 x 2048, at R in {1, 2, 3, 255} x C in {1,
    33, 2048}, and with L and poly all p - 1.  Then G's device time round
    by round at the main path's shapes (tools/g_rounds.py) -> details."""
    from spartan2_tpu_torch.field.limbs import to_device
    from spartan2_tpu_torch.pcs.hyrax import hyrax_bind, hyrax_bind_plain
    from spartan2_tpu_torch.provider.engines import get_engine
    from spartan2_tpu_torch.sumcheck.device import (cubiceq_evals, cubiceq_evals_plain,
                                                    new_ticket)
    from tools.g_rounds import g_rounds, g_summary, time_g_rounds

    detail = []
    for ename in ("P256HyraxEngine", "PallasHyraxEngine"):
        F = get_engine(ename).scalar
        gen = torch.Generator().manual_seed(21)
        ticket = new_ticket(dev)
        launched = [0]

        def full(n, kind):
            if kind == "random":
                return rand_field(n, F, gen, dev)
            v = 0 if kind == "zeros" else F.modulus - 1
            return to_device([v], F, dev).expand(n, 8).contiguous()

        def g_check(name, vecs, half, hi_len, EL, ER, rlog, zc, fb, shard=0, lw=0):
            args = (half, hi_len, EL, ER, rlog, zc, fb, F, shard, lw)
            want = cubiceq_evals_plain(*vecs, *args)
            for _ in range(2):
                got = cubiceq_evals(*vecs, *args, ticket=ticket)
                launched[0] += 1
                if got.shape != (1, 3, 8) or not torch.equal(got, want):
                    raise RuntimeError(f"kernel G ({ename}, {name}) differs from its "
                                       "plain version")

        vecs = [full(1 << 20, "random") for _ in range(3)]
        for r in g_rounds(20, 528177)[:2]:
            g_check(f"main path round {r['round']}", vecs, r["half"], r["hi_len"],
                    full(1 << r["el_vars"], "random"), full(1 << r["er_vars"], "random"),
                    r["rlog"], r["zero_check"], False)
        n = 1 << G_CASE_M
        half, some = n // 2, n // 6
        rl = G_CASE_M - G_CASE_M // 2
        for kind in ("random", "zeros", "p-1"):
            vecs = [full(n, kind) for _ in range(3)]
            # (name, EL entries or None, ER entries, rlog, zc, fb, hi_len, shard, lw)
            cases = [("two-level, zero_check, hi_len 0", half >> rl, 1 << rl, rl, True,
                      False, 0, 0, 0),
                     ("two-level, zero_check", half >> rl, 1 << rl, rl, True, False, some,
                      0, 0),
                     ("two-level", half >> rl, 1 << rl, rl, False, False, half, 0, 0),
                     ("two-level, fallback", half >> rl, 1 << rl, rl, False, True, some, 0,
                      0),
                     ("two-level, zero_check, fallback", half >> rl, 1 << rl, rl, True,
                      True, half, 0, 0),
                     ("two-level, rows of 8", half >> 3, 8, 3, False, True, some, 0, 0),
                     ("two-level, shard 1 of 2", half >> rl, 1 << rl, rl, False, False,
                      some // 2, 1, 1),
                     ("two-level, shard 3 of 4, zero_check", half >> rl, 1 << rl, rl, True,
                      False, some // 4, 3, 2),
                     ("two-level, shard 1 of 4, lw > rlog", half << 1, 2, 1, False, True,
                      some // 4, 1, 2),
                     ("one-level", None, half, 0, False, False, half, 0, 0),
                     ("one-level, zero_check, fallback", None, half, 0, True, True, some,
                      0, 0),
                     ("one-level, shard 3 of 4", None, half, 0, False, True, some // 4, 3,
                      2)]
            for name, nel, ner, rlog, zc, fb, hi, shard, lw in cases:
                h = half >> lw
                EL = None if nel is None else full(nel, kind)
                g_check(f"{name}, {kind}", vecs, h, min(hi, h), EL, full(ner, kind), rlog,
                        zc, fb, shard, lw)
        print(f"equal to plain: cubiceq_evals on {ename}: the main path's round 0 "
              f"(peeled) and round 1 at 2^20, and {len(cases)} mode cases at "
              f"2^{G_CASE_M} on random, zero and p - 1 inputs; {launched[0]} launches on "
              "one ticket", flush=True)

        shapes = [(256, 2048, "random")] + [(R, C, "random") for R in (1, 2, 3, 255)
                                            for C in (1, 33, 2048)] + [(256, 2048, "p-1")]
        for R, C, kind in shapes:
            L = full(R, kind)
            poly = full(R * C, kind).reshape(R, C, 8)
            if not torch.equal(hyrax_bind(L, poly, F), hyrax_bind_plain(L, poly, F)):
                raise RuntimeError(f"kernel 4 ({ename}, {R} x {C}, {kind}) differs from its "
                                   "plain version")
        L = full(256, "random")
        poly = full(256 * 2048, "random").reshape(256, 2048, 8)
        rec = detail_record(f"hyrax_bind 256 x 2048 on {ename}",
                            cuda_ms(lambda: hyrax_bind(L, poly, F), 20),
                            once_ms(lambda: hyrax_bind_plain(L, poly, F))[1],
                            *hyrax_bind_bound(256, 2048))
        rec["device_ms"] = device_ms(lambda: hyrax_bind(L, poly, F), 20)
        detail.append(rec)
        print(f"equal to plain: hyrax_bind on {ename} at {len(shapes)} shapes (256 x 2048, "
              "R in {1, 2, 3, 255} x C in {1, 33, 2048}, all p - 1): " + json.dumps(rec),
              flush=True)

    F = get_engine("P256HyraxEngine").scalar
    rounds = time_g_rounds(F)
    summary = g_summary(rounds)
    print("kernel G round by round at 2^20 (device us by torch.profiler, ms by CUDA "
          "events): " + json.dumps([{k: r[k] for k in ("round", "half", "ms", "device_us")}
                                    for r in rounds]) + "; " + json.dumps(summary),
          flush=True)
    detail.append({"name": "kernel G round by round, device us", **summary})
    return detail


def check_pallas(dev) -> list:
    """The curve kernels on the Pallas curve (a = 0, both moduli below
    2^255) against their plain versions on the card: comb build and rows,
    the MSM of kernel 5 and the Hyrax row bind over Pallas's scalar field
    -> detail records."""
    from spartan2_tpu_torch.ec.comb import comb_build, comb_rows, comb_rows_plain, n_windows, to_affine
    from spartan2_tpu_torch.ec.msm import msm, msm_plain, msm_windows, to_jacobian
    from spartan2_tpu_torch.field.limbs import to_device
    from spartan2_tpu_torch.pcs.hyrax import FULL_BITS, SMALL_BITS, hyrax_bind, hyrax_bind_plain
    from spartan2_tpu_torch.provider.engines import get_engine

    engine = get_engine("PallasHyraxEngine")
    curve, F = engine.curve, engine.scalar
    # comb_build's three tables at the main path's width, each against its
    # plain version (check_comb_build)
    W = MAIN_CFG["width"]
    ck, _ = engine.pcs.setup(b"ck", 2 * W, W, dev)
    detail = check_comb_build(curve, ck.ck, ck.h, n_windows(SMALL_BITS), dev, F, "Pallas ")
    # the comb rows, the MSM and the bind at 64 columns: the table of the
    # first 64 generators, the first 64 columns of the table just held
    # against its plain version (columns are independent)
    C = 64
    gen = torch.Generator().manual_seed(17)
    gx = to_device([g[0] for g in ck.ck[:C]], curve.base, dev, mont=True)
    gy = to_device([g[1] for g in ck.ck[:C]], curve.base, dev, mont=True)
    nw = n_windows(FULL_BITS)
    table = comb_build(gx, gy, nw, curve)
    fx = to_device([g[0] for g in ck.ck], curve.base, dev, mont=True)
    fy = to_device([g[1] for g in ck.ck], curve.base, dev, mont=True)
    same_or_raise(f"comb_build on Pallas ({nw} windows x {C}) against the first {C} columns of "
                  f"the {W}-column table", table, comb_build(fx, fy, nw, curve)[:, :, :C], F)
    del fx, fy
    sc = rand_field(16 * C, F, gen, dev).reshape(16, C, 8)
    want, rms = once_ms(lambda: comb_rows_plain(sc, table, curve))
    same_or_raise("comb_rows on Pallas (16 x 64, full width)",
                  comb_rows(sc, table, curve), want, F)
    pts = to_jacobian(to_affine(comb_rows(sc, table, curve), curve), curve, dev)
    ms_sc = rand_field(16, F, gen, dev)
    want, mms = host_plain(lambda s_, p_: msm_plain(s_, p_, curve), ms_sc, pts)
    same_or_raise("msm on Pallas (16 points)", msm(ms_sc, pts, curve).cpu(), want, F)
    L = rand_field(256, F, gen, dev)
    poly = rand_field(256 * C, F, gen, dev).reshape(256, C, 8)
    want, hms = once_ms(lambda: hyrax_bind_plain(L, poly, F))
    same_or_raise("hyrax_bind over Pallas's scalar field (256 x 64)",
                  hyrax_bind(L, poly, F), want, F)
    # bounds as the P-256 rows count them: the comb rows' additions of
    # nonzero digits, the MSM's products, the bind's products
    for name, fn, pm, (nbytes, muls) in (
            ("Pallas comb_rows 16 x 64", lambda: comb_rows(sc, table, curve), rms,
             comb_bound_args(sc, nw)),
            ("Pallas msm 16 points", lambda: msm(ms_sc, pts, curve), mms,
             (16 * (32 + 96) + 96, msm_point_ops(ms_sc[None], msm_windows(FULL_BITS), curve))),
            ("Pallas hyrax_bind 256 x 64", lambda: hyrax_bind(L, poly, F), hms,
             (256 * C * 32 + 256 * 32 + C * 32, 256 * C + C))):
        detail.append(detail_record(name, cuda_ms(fn, 3), pm, nbytes, muls))
    return detail


MSM_SHAPES = ((43, 2), (15, 16), (1, 256))  # ZK verify's fold, NN's folds, kernel 5


def _msm_case(curve, R: int, I: int, nbits: int, seed: int, dev):
    """(scalars (R, I, 8), points (R, I, 3, 8)) on the card: multiples of
    the generator and scalars below 2^nbits (below q), with the edge cases:
    zero scalars, q - 1, a point repeated with its scalar (the window
    sums' doubling case), a point beside its negation (their identity
    case), a point at infinity; rows of their own where R > 4, else inside
    the one row."""
    from spartan2_tpu_torch.ec.msm import to_jacobian
    from spartan2_tpu_torch.field.limbs import to_device

    q = curve.scalar.modulus
    rnd = random.Random(seed)
    top = min(1 << nbits, q)
    sc = [[rnd.randrange(top) for _ in range(I)] for _ in range(R)]
    pts = [[curve.scalar_mul(rnd.randrange(1, q), curve.generator) for _ in range(I)]
           for _ in range(R)]

    def neg(pt):
        return (pt[0], (-pt[1]) % curve.base.modulus)

    if R > 4:
        sc[0] = [0] * I
        sc[1] = [(q - 1) % top] * I
        pts[2][1], sc[2][1] = pts[2][0], sc[2][0]
        pts[3][1], sc[3][1] = neg(pts[3][0]), sc[3][0]
        pts[4][0] = None
    else:
        row, p_ = sc[0], pts[0]
        row[0:2] = [0, 0]
        row[2] = (q - 1) % top
        p_[5], row[5] = p_[4], row[4]
        p_[7], row[7] = neg(p_[6]), row[6]
        p_[8] = None
    scal = to_device([v for row in sc for v in row], curve.scalar, dev).reshape(R, I, 8)
    jac = to_jacobian([pt for row in pts for pt in row], curve, dev).reshape(R, I, 3, 8)
    return scal, jac


def check_msm(dev, probe) -> tuple[list, dict]:
    """Kernels C and 5 at the main paths' shapes (R x I = 43 x 2, 15 x 16
    and kernel 5's 256 points) on P-256 and Pallas (a = 0), nbits 256 and
    40, with the edge cases of ``_msm_case``: each equal to its plain
    version (run on the host) limb for limb and timed; then, on P-256,
    kernel C's latency floor: 255 doublings in sequence, each the ladder's
    quad doubling timed alone by ``probe`` (tools/curve_latency.py
    DBL_CHAIN, held against the plain doublings).  Beside it, for
    reference and not as floors: one thread's 255 doublings of the old
    group law (sp2_msm_per_lane, n = 1, scalar 2^255) and kernel C's own
    time at one point (R = I = 1, scalar 2^255) -> (detail records,
    floors)."""
    from spartan2_tpu_torch.ec.comb import pt_dbl_n
    from tools.curve_latency import dbl_chain, dbl_chain_floor_ms
    from spartan2_tpu_torch.ec.curve import get_curve
    from spartan2_tpu_torch.ec.msm import (
        msm, msm_plain, msm_points_per_lane, msm_points_per_lane_plain, msm_rows,
        msm_rows_plain, msm_windows, to_jacobian)
    from spartan2_tpu_torch.field.limbs import to_device

    detail = []
    for cname in ("p256", "pallas"):
        curve = get_curve(cname)
        F = curve.base
        for R, I in MSM_SHAPES:
            for nbits in (256, 40):
                sc, pts = _msm_case(curve, R, I, nbits, 1000 * R + I + nbits, dev)
                name = f"{'msm' if R == 1 else 'msm_rows'} {cname} R={R} I={I} nbits {nbits}"
                if R == 1:
                    fn = lambda: msm(sc[0], pts[0], curve, nbits)  # noqa: E731
                    want, pms = host_plain(lambda s_, p_: msm_plain(s_, p_, curve, nbits),
                                           sc[0], pts[0])
                else:
                    fn = lambda: msm_rows(sc, pts, curve, nbits)  # noqa: E731
                    want, pms = host_plain(
                        lambda s_, p_: msm_rows_plain(s_, p_, curve, nbits), sc, pts)
                same_or_raise(f"{name} (edge cases)", fn().cpu(), want, F)
                if nbits == 256:
                    detail.append(detail_record(
                        name, cuda_ms(fn, 5), pms, R * I * (32 + 96) + R * 96,
                        msm_point_ops(sc, msm_windows(nbits), curve)))
    curve = get_curve("p256")
    F = curve.base
    G = curve.generator
    s255 = to_device([1 << 255], curve.scalar, dev)
    qx, qy = (to_device([c], F, dev, mont=True) for c in G)
    lane = lambda: msm_points_per_lane(s255, qx, qy, curve)  # noqa: E731
    want, _ = host_plain(lambda s_, x_, y_: msm_points_per_lane_plain(s_, x_, y_, curve),
                         s255, qx, qy)
    same_or_raise("msm_points_per_lane n = 1, scalar 2^255", lane().cpu(), want, F)
    lane_ms = cuda_ms(lane, 5)
    P1 = to_jacobian([G], curve, dev).reshape(1, 1, 3, 8)
    one = lambda: msm_rows(s255.reshape(1, 1, 8), P1, curve)  # noqa: E731
    want, _ = host_plain(lambda s_, p_: msm_rows_plain(s_, p_, curve), s255.reshape(1, 1, 8),
                         P1)
    same_or_raise("msm_rows R = I = 1, scalar 2^255", one().cpu(), want, F)
    one_point_ms = cuda_ms(one, 5)
    want = pt_dbl_n(P1.reshape(3, 8).cpu(), 255, curve)
    same_or_raise("ladder doubling chain (255 quad doublings)",
                  dbl_chain(probe, P1.reshape(3, 8), 255, curve).cpu(), want, F)
    floor_ms, dbl_us = dbl_chain_floor_ms(probe, P1.reshape(3, 8), curve)
    floors = {"latency_floor_ms": floor_ms, "dbl_us": dbl_us, "old_dbl_us": lane_ms * 1e3 / 256,
              "old_lane_ms": lane_ms, "one_point_ms": one_point_ms}
    print(f"kernel C latency floor (P-256): 255 ladder doublings in sequence {floor_ms:.4f} "
          f"ms ({dbl_us:.3f} us a doubling, timed alone); for reference, not floors: one "
          f"thread's 255 doublings and an addition (sp2_msm_per_lane, old group law) "
          f"{lane_ms:.4f} ms ({floors['old_dbl_us']:.3f} us a doubling), kernel C at one "
          f"point (scalar 2^255) {one_point_ms:.4f} ms", flush=True)
    return detail, floors



def build_host_c() -> float:
    """Build (or load) the host C libraries, Keccak and curve; -> seconds."""
    from spartan2_tpu_torch.ec.curve import _native_ec
    from spartan2_tpu_torch.transcript.keccak import keccak256

    t0 = time.perf_counter()
    _native_ec()
    keccak256(b"")
    return time.perf_counter() - t0


HOST_CURVE_N = (17, 2048)  # a verifier-circuit row commit (16 + blind); a width


def _host_ms(fn, reps: int) -> tuple:
    """(result, mean host milliseconds over reps runs)."""
    t0 = time.perf_counter()
    for _ in range(reps):
        res = fn()
    return res, (time.perf_counter() - t0) * 1e3 / reps


def check_host_curve() -> list:
    """The host curve in C (native/ec_host.c) against its Python versions
    on this machine's host: msm against msm_plain at 17 and 2048 points,
    scalar_mul against scalar_mul_plain, on P-256 and Pallas -> detail
    records (host ms)."""
    from spartan2_tpu_torch.ec.curve import get_curve

    detail = []
    rng = random.Random(31)
    for name in ("p256", "pallas"):
        c = get_curve(name)
        q = c.scalar.modulus
        gens = c.from_label(b"chip_smoke host curve", max(HOST_CURVE_N))
        for n in HOST_CURVE_N:
            sc = [rng.randrange(q) for _ in range(n)]
            sc[0], pts = 0, list(gens[:n])
            pts[n // 2] = None
            got, ms = _host_ms(lambda: c.msm(sc, pts), 20)
            want, pms = _host_ms(lambda: c.msm_plain(sc, pts), 1 if n > 100 else 3)
            if got != want:
                raise RuntimeError(f"host C msm on {name} at n = {n} differs from msm_plain")
            print(f"equal to plain: host C msm on {name}, n = {n}", flush=True)
            detail.append({"name": f"host C msm {name} n={n}", "host_ms": ms,
                           "plain_host_ms": pms})
        ks = [0, 1, q - 1] + [rng.randrange(q) for _ in range(5)]
        for pt in (c.generator, gens[1], None):
            for k in ks:
                if c.scalar_mul(k, pt) != c.scalar_mul_plain(k, pt):
                    raise RuntimeError(f"host C scalar_mul on {name} differs from "
                                       "scalar_mul_plain")
        k = ks[-1]
        _, ms = _host_ms(lambda: c.scalar_mul(k, gens[1]), 50)
        _, pms = _host_ms(lambda: c.scalar_mul_plain(k, gens[1]), 10)
        print(f"equal to plain: host C scalar_mul on {name} ({len(ks)} scalars x 3 "
              "points)", flush=True)
        detail.append({"name": f"host C scalar_mul {name}", "host_ms": ms,
                       "plain_host_ms": pms})
    return detail


# ---------------------------------------------------------------------------
# (f) the curve phase: the last four device functions
# ---------------------------------------------------------------------------

CURVE_N = 2048  # lanes: a Hyrax width
CURVE_N_PAD = 1000  # a masked sum padded with the identity
CURVE_M = 20  # variables of the MLE table: the main path's 2^20
CURVE_PATH = ("wrapper calls of phase (f), the curve functions' own path (no "
              "prove calls them): P-256 and Pallas")
CURVE_ENTRIES = {"msm_binary": "sp2_msm_binary", "msm_points_per_lane": "sp2_msm_per_lane",
                 "scalar_mul_host_base": "sp2_scalar_mul_base"}
CURVE_REPLACES = {"msm_binary": "spartan2_tpu/ec/device.py:445",
                  "msm_points_per_lane": "spartan2_tpu/ec/device.py:468",
                  "scalar_mul_host_base": "spartan2_tpu/ec/device.py:474",
                  "mle_evaluate_device": "spartan2_tpu/polys/multilinear.py:81"}


def _curve_inputs(name: str, gen: torch.Generator, dev) -> dict:
    """Seeded inputs of phase (f) on one curve: 2048 affine points, bits,
    scalars (full width with zeros, 1, q - 1 and the exceptional q and
    q + 2; below 2^64 with zeros), the host scalars and an MLE table."""
    from spartan2_tpu_torch.ec.curve import get_curve
    from spartan2_tpu_torch.field import ops
    from spartan2_tpu_torch.field.limbs import to_device

    c = get_curve(name)
    q, F = c.scalar.modulus, c.scalar
    pts = c.from_label(b"chip_smoke curve phase", CURVE_N)
    qx = to_device([p[0] for p in pts], c.base, dev, mont=True)
    qy = to_device([p[1] for p in pts], c.base, dev, mont=True)
    bits = torch.randint(0, 2, (CURVE_N,), generator=gen, dtype=torch.int32)
    rng = random.Random(name)
    full = [rng.randrange(q) for _ in range(CURVE_N)]
    full[:5] = [0, 1, q - 1, q, q + 2]  # q, q + 2: the mixed add's exceptional cases
    full[5::37] = [0] * len(full[5::37])
    small = [rng.randrange(1 << 64) for _ in range(CURVE_N)]
    small[::17] = [0] * len(small[::17])

    def raw(vals):  # 256-bit values as they are (q and q + 2 not reduced)
        buf = b"".join(v.to_bytes(32, "little") for v in vals)
        return torch.frombuffer(bytearray(buf), dtype=torch.int32).reshape(-1, 8).to(dev)

    table = ops.to_mont(rand_field(1 << CURVE_M, F, gen, dev), F)
    return {"curve": c, "pts": pts, "qx": qx, "qy": qy, "bits": bits.to(dev),
            "full": full, "small": small, "sc_full": raw(full), "sc_small": raw(small),
            "ks": [0, 1, q - 1, rng.randrange(q)],
            "table": table,
            "table1": to_device([rng.randrange(q) for _ in range(2)], F, dev, mont=True),
            "r": to_device([rng.randrange(q) for _ in range(CURVE_M)], F, dev, mont=True)}


def _drive_curve_path(inp: dict) -> dict:
    """Every curve function once through its wrapper, as a caller would."""
    from spartan2_tpu_torch.ec.msm import (msm_binary, msm_points_per_lane,
                                           scalar_mul_host_base)
    from spartan2_tpu_torch.polys.multilinear import mle_evaluate_device

    c, qx, qy, bits = inp["curve"], inp["qx"], inp["qy"], inp["bits"]
    n = CURVE_N_PAD
    return {
        "binary": msm_binary(bits, qx, qy, c),
        "binary_pad": msm_binary(bits[:n], qx[:n].contiguous(), qy[:n].contiguous(), c),
        "binary_zero": msm_binary(torch.zeros_like(bits), qx, qy, c),
        "lane": msm_points_per_lane(inp["sc_full"], qx, qy, c),
        "lane64": msm_points_per_lane(inp["sc_small"], qx, qy, c, 64),
        "base": [scalar_mul_host_base(k, qx, qy, c) for k in inp["ks"]],
        "mle": mle_evaluate_device(inp["table"], inp["r"], c.scalar),
        "mle1": mle_evaluate_device(inp["table1"], inp["r"][:1].contiguous(), c.scalar),
    }


def _hold_curve_path(name: str, inp: dict, got: dict) -> dict:
    """Each result of the curve path against its plain version on the card
    (exact), and against the host (C curve, Python MLE) -> plain ms."""
    from spartan2_tpu_torch.ec.comb import to_affine
    from spartan2_tpu_torch.ec.msm import (msm_binary_plain, msm_points_per_lane_plain,
                                           scalar_mul_host_base_plain)
    from spartan2_tpu_torch.field.limbs import limbs_to_ints
    from spartan2_tpu_torch.polys.multilinear import (mle_evaluate_device_plain,
                                                      mle_evaluate_host)

    c, qx, qy, bits = inp["curve"], inp["qx"], inp["qy"], inp["bits"]
    F, n, pts = c.scalar, CURVE_N_PAD, inp["pts"]
    pms = {}
    want, pms["msm_binary"] = once_ms(lambda: msm_binary_plain(bits, qx, qy, c))
    same_or_raise(f"msm_binary on {name}, n = {CURVE_N}", got["binary"], want, F)
    want = msm_binary_plain(bits[:n], qx[:n], qy[:n], c)
    same_or_raise(f"msm_binary on {name}, n = {n} (padded)", got["binary_pad"], want, F)
    want = msm_binary_plain(torch.zeros_like(bits), qx, qy, c)
    same_or_raise(f"msm_binary on {name}, no bit set", got["binary_zero"], want, F)
    hb = bits.tolist()
    host = [c.msm(hb, pts), c.msm(hb[:n], pts[:n]), None]
    if to_affine(torch.stack([got["binary"], got["binary_pad"], got["binary_zero"]]),
                 c) != host:
        raise RuntimeError(f"msm_binary on {name} differs from the host C msm")
    want, pms["msm_points_per_lane"] = once_ms(
        lambda: msm_points_per_lane_plain(inp["sc_full"], qx, qy, c))
    same_or_raise(f"msm_points_per_lane on {name}, nbits 256", got["lane"], want, F)
    want = msm_points_per_lane_plain(inp["sc_small"], qx, qy, c, 64)
    same_or_raise(f"msm_points_per_lane on {name}, nbits 64", got["lane64"], want, F)
    for j in (0, 1, 2, 3, 4, 5, CURVE_N - 1):
        for key, vals in (("lane", inp["full"]), ("lane64", inp["small"])):
            if to_affine(got[key][j : j + 1], c)[0] != c.scalar_mul(vals[j], pts[j]):
                raise RuntimeError(f"msm_points_per_lane on {name}: lane {j} differs "
                                   "from the host C scalar_mul")
    for k, res in zip(inp["ks"], got["base"]):
        want, ms = once_ms(lambda: scalar_mul_host_base_plain(k, qx, qy, c))
        if k == inp["ks"][-1]:
            pms["scalar_mul_host_base"] = ms
        same_or_raise(f"scalar_mul_host_base on {name}, k of {k.bit_length()} bits",
                      res, want, F)
        if to_affine(res[:3], c) != [c.scalar_mul(k, p) for p in pts[:3]]:
            raise RuntimeError(f"scalar_mul_host_base on {name} differs from the host")
    want, pms["mle_evaluate_device"] = once_ms(
        lambda: mle_evaluate_device_plain(inp["table"], inp["r"], F))
    same_or_raise(f"mle_evaluate_device on {name}'s scalar field, m = {CURVE_M}",
                  got["mle"], want, F)
    r1 = inp["r"][:1]
    same_or_raise(f"mle_evaluate_device on {name}'s scalar field, m = 1", got["mle1"],
                  mle_evaluate_device_plain(inp["table1"], r1, F), F)
    r_host = limbs_to_ints(inp["r"], F, mont=True)
    for key, tab, r in (("mle", "table", r_host), ("mle1", "table1", r_host[:1])):
        host_val = mle_evaluate_host(F, limbs_to_ints(inp[tab], F, mont=True), r)
        if limbs_to_ints(got[key], F, mont=True) != [host_val]:
            raise RuntimeError(f"{key} on {name} differs from mle_evaluate_host")
    print(f"curve phase on {name}: every result equals the host's", flush=True)
    return pms


def check_curve(dev) -> tuple:
    """(f) msm_binary, msm_points_per_lane, scalar_mul_host_base and
    mle_evaluate_device on P-256 and Pallas: the counts set to 0, each
    function driven through its wrapper, the counts read; then every
    result against its plain version on the card and against the host
    -> (kernel records, detail records)."""
    from spartan2_tpu_torch.ec.msm import (MSM, msm_binary, msm_points_per_lane,
                                           scalar_mul_host_base)
    from spartan2_tpu_torch.polys.multilinear import mle_evaluate_device
    from spartan2_tpu_torch.sumcheck.device import SUMCHECK

    gen = torch.Generator().manual_seed(41)
    inputs = {name: _curve_inputs(name, gen, dev) for name in ("p256", "pallas")}
    torch.cuda.synchronize()
    for k in (MSM, SUMCHECK):
        k.reset()
    got = {name: _drive_curve_path(inp) for name, inp in inputs.items()}
    torch.cuda.synchronize()
    launches = {fn: MSM.entry_launches.get(e, 0) for fn, e in CURVE_ENTRIES.items()}
    launches["mle_evaluate_device"] = SUMCHECK.entry_launches.get("sp2_bind_dev", 0)
    print(f"curve phase launches: {json.dumps(launches)}", flush=True)
    for fn, count in launches.items():
        if count <= 0:
            raise RuntimeError(f"{fn} launched no kernel in the curve phase")
    pms = {name: _hold_curve_path(name, inputs[name], got[name]) for name in inputs}

    out, detail = [], []
    for name, inp in inputs.items():
        c, qx, qy, bits = inp["curve"], inp["qx"], inp["qy"], inp["bits"]
        F = c.scalar
        sel = int((bits == 1).sum())
        k = inp["ks"][-1]
        runs = {
            "msm_binary": (
                lambda: msm_binary(bits, qx, qy, c),
                CURVE_N * 4 + sel * 64 + 96, max(sel - 1, 0) * MONT_MULS_PER_ADD),
            "msm_points_per_lane": (
                lambda: msm_points_per_lane(inp["sc_full"], qx, qy, c),
                CURVE_N * (32 + 64 + 96),
                sum(max(v.bit_length() - 1, 0) * dbl_muls(c)
                    + max(bin(v).count("1") - 1, 0) * MONT_MULS_PER_MADD
                    for v in inp["full"])),
            "scalar_mul_host_base": (
                lambda: scalar_mul_host_base(k, qx, qy, c),
                CURVE_N * (64 + 96) + 32,
                CURVE_N * ((k.bit_length() - 1) * dbl_muls(c)
                           + (bin(k).count("1") - 1) * MONT_MULS_PER_MADD)),
            "mle_evaluate_device": (
                lambda: mle_evaluate_device(inp["table"], inp["r"], F),
                (1 << CURVE_M) * 32 + CURVE_M * 32 + 32, (1 << CURVE_M) - 1),
        }
        for fn, (run, nbytes, muls) in runs.items():
            ms = cuda_ms(run, 3 if fn in ("msm_points_per_lane",
                                          "scalar_mul_host_base") else 10)
            if name == "p256":
                source = ("spartan2_tpu_torch/csrc/sumcheck.cu"
                          if fn == "mle_evaluate_device" else "spartan2_tpu_torch/csrc/msm.cu")
                out.append(kernel_record(fn, CURVE_REPLACES[fn], launches[fn], CURVE_PATH, ms,
                                         pms[name][fn], nbytes, muls, source))
            else:
                detail.append(detail_record(f"Pallas {fn} (phase (f) shape)", ms,
                                            pms[name][fn], nbytes, muls))
    return out, detail


# ---------------------------------------------------------------------------
# the mesh phase: W ranks on the one card, a gloo group
# ---------------------------------------------------------------------------

MESH_W = 2  # ranks of the SNARK proves
SUMCHECK_W = 4  # ranks of the sharded sum-checks
MESH_DEADLINE = 600  # seconds for one run of ranks
# the main paths' configurations: SHA-256 over 1 KiB at Hyrax width 2048,
# NeutronNova over NN_STEPS one-block steps
MAIN_CFG = {"msg_len": 1024, "width": 2048, "nn_steps": NN_STEPS}


def _sha_circuit(cfg: dict):
    from spartan2_tpu_torch.frontend.gadgets.sha256 import Sha256Circuit

    return Sha256Circuit(bytes(i & 0xFF for i in range(cfg["msg_len"])))


def _path_kernels():
    """Every CUDA source's kernel handle; NeutronNova's NIFS last."""
    from spartan2_tpu_torch.ec.comb import COMB
    from spartan2_tpu_torch.ec.msm import MSM
    from spartan2_tpu_torch.pcs.hyrax import HYRAX_BIND
    from spartan2_tpu_torch.r1cs.sparse import SPMV
    from spartan2_tpu_torch.sumcheck.device import CUBICEQ, SUMCHECK
    from spartan2_tpu_torch.sumcheck.nifs import NIFS
    from spartan2_tpu_torch.sumcheck.prove import ROUND_FINISH
    from spartan2_tpu_torch.transcript.device import TRANSCRIPT

    return [SPMV, SUMCHECK, COMB, HYRAX_BIND, MSM, TRANSCRIPT, ROUND_FINISH, CUBICEQ, NIFS]


def _gather_ms(mesh, rows: int, reps: int = 50) -> float:
    """Host ms of one all_gather of a round's (rows, 3, 8) int32 partial
    sums on the card, after a first one that lines the ranks up."""
    part = torch.zeros(rows, 3, 8, dtype=torch.int32, device=mesh.device)
    mesh.all_gather(part)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        mesh.all_gather(part)
    return (time.perf_counter() - t0) * 1e3 / reps


def mesh_snark_rank(mesh, cfg: dict):
    """A rank of the SNARK mesh: SpartanSNARK on SHA-256 1 KiB and
    NeutronNovaZkSNARK on 16 SHA-256 steps, each set up on this rank and
    proved on the mesh from the single-device run's seeds (the first
    prove counted and kept, a second timed); rank 1 verifies both; the
    precommitted witness's 256 rows committed row-sharded."""
    from spartan2_tpu_torch.field.limbs import to_device
    from spartan2_tpu_torch.frontend.gadgets.sha256 import Sha256Circuit
    from spartan2_tpu_torch.parallel.sumcheck_shard import commit_rows_sharded
    from spartan2_tpu_torch.pcs.hyrax import SMALL_BITS
    from spartan2_tpu_torch.provider.engines import get_engine
    from spartan2_tpu_torch.snark.neutronnova import NeutronNovaZkSNARK as NN
    from spartan2_tpu_torch.snark.spartan import SpartanSNARK
    from spartan2_tpu_torch.utils.serde import neutronnova_proof_to_bytes, spartan_proof_to_bytes

    kernels = _path_kernels()
    engine, circuit, dev = get_engine("P256HyraxEngine"), _sha_circuit(cfg), mesh.device
    out = {"rank": mesh.rank, "backend": mesh.backend}
    t0 = time.perf_counter()
    pk, vk = SpartanSNARK.setup(engine, circuit, width=cfg["width"], device=dev)
    prep = SpartanSNARK.prep_prove(pk, circuit, is_small=True, rng=det(1))
    out["spartan_setup_prep_s"] = time.perf_counter() - t0
    for k in kernels:
        k.reset()
    g0, gs0 = mesh.gathers, mesh.gather_s
    (proof, _), t1 = _timed(lambda: SpartanSNARK.prove(
        pk, circuit, prep, is_small=True, rng=det(2), mesh=mesh))
    out["spartan_launches"] = {k.name: dict(k.entry_launches) for k in kernels}
    out["spartan_gathers"] = [mesh.gathers - g0, mesh.gather_s - gs0]
    _, t2 = _timed(lambda: SpartanSNARK.prove(pk, circuit, prep, is_small=True,
                                              rng=det(3), mesh=mesh))
    out["spartan_prove_s"] = [t1 / 1e3, t2 / 1e3]
    out["spartan"] = spartan_proof_to_bytes(proof, engine)
    if mesh.rank == 1:
        out["spartan_verifies"] = SpartanSNARK.verify(proof, vk) == circuit.public_values()
    S = pk.S
    wit = prep.ps.W[S.num_shared : S.num_shared + S.num_precommitted]
    scp = to_device(wit, engine.scalar, dev).reshape(-1, S.width, 8)
    comb = pk.ck.comb(SMALL_BITS)
    for k in kernels:
        k.reset()
    out["commit"] = commit_rows_sharded(mesh, comb, scp).cpu()
    out["commit_launches"] = kernels[2].launches
    out["commit_ms"] = _timed(lambda: commit_rows_sharded(mesh, comb, scp))[1]
    out["gather_ms"] = {rows: _gather_ms(mesh, rows) for rows in (1, 1024)}
    del pk, vk, prep, proof

    n_steps = cfg["nn_steps"]
    steps = [Sha256Circuit(bytes([i] * 55)) for i in range(n_steps)]
    core = Sha256Circuit(bytes(55))
    t0 = time.perf_counter()
    npk, nvk = NN.setup(engine, steps[0], core, n_steps, width=cfg["width"], device=dev)
    nprep = NN.prep_prove(npk, steps, core, is_small=True, rng=det(21))
    out["nn_setup_prep_s"] = time.perf_counter() - t0
    for k in kernels:
        k.reset()
    g0, gs0 = mesh.gathers, mesh.gather_s
    (nproof, nprep), t1 = _timed(lambda: NN.prove(
        npk, steps, core, nprep, is_small=True, rng=det(22), mesh=mesh))
    out["nn_launches"] = {k.name: dict(k.entry_launches) for k in kernels}
    out["nn_gathers"] = [mesh.gathers - g0, mesh.gather_s - gs0]
    _, t2 = _timed(lambda: NN.prove(npk, steps, core, nprep, is_small=True,
                                    rng=det(23), mesh=mesh))
    out["nn_prove_s"] = [t1 / 1e3, t2 / 1e3]
    out["nn"] = neutronnova_proof_to_bytes(nproof, engine)
    if mesh.rank == 1:
        out["nn_verifies"] = NN.verify(nproof, nvk, n_steps) == (
            [c.public_values() for c in steps], core.public_values())
    return out


def _sumcheck_inputs(pk, prep, circuit) -> dict:
    """SHA-256 1 KiB's outer and inner sum-check inputs on the host (as in
    check_sumchecks (c)/(d)): Az/Bz/Cz, the taus, eff, the transcript
    before each sum-check, poly_ABC, z and the inner claim."""
    from spartan2_tpu_torch.snark.spartan import SpartanSNARK
    from spartan2_tpu_torch.sumcheck.device import DOT, round_evals
    from spartan2_tpu_torch.sumcheck.prove import prove_cubic_eq

    F = pk.engine.scalar
    S = pk.S
    with torch.inference_mode():
        transcript, U, W, z, taus, ABC = SpartanSNARK.instance(pk, circuit, prep, True,
                                                               det(40))
    t_outer = (transcript.state, transcript.round)
    t = _clone(transcript)
    _, rx, _ = prove_cubic_eq(t, taus, *[v.clone() for v in ABC], F)
    abc = S.bind_and_prepare_poly_ABC(rx, random.Random(41).randrange(F.modulus))
    claim = round_evals(DOT, S.num_cols, [abc, z], F)[0]
    return {"ABC": ABC.cpu(), "taus": taus, "eff": S.num_cons_unpadded,
            "t_outer": t_outer, "t_inner": (t.state, t.round), "abc": abc.cpu(),
            "z": z.cpu(), "claim": claim, "nv": S.num_vars,
            "ne": S.num_cols - S.num_vars}


def run_sumchecks(inp: dict, engine: str, dev, mesh=None) -> dict:
    """The prove's outer and inner sum-checks on ``inp`` (sharded
    on ``mesh``), each run three times from the same inputs and timed on
    the host to a synchronize -> the first run's coefficients, challenges,
    finals and state, and the ms of every run."""
    from spartan2_tpu_torch.field.limbs import to_device
    from spartan2_tpu_torch.provider.engines import get_engine
    from spartan2_tpu_torch.snark.spartan import SpartanSNARK
    from spartan2_tpu_torch.transcript.device import DeviceTranscript, host_bytes

    F = get_engine(engine).scalar
    ABC, abc, z = (inp[k].to(dev) for k in ("ABC", "abc", "z"))
    claim = to_device([inp["claim"]], F, dev, mont=True)[0]
    out = {"outer_ms": [], "inner_ms": []}
    for rep in range(3):
        td = DeviceTranscript(F, state=host_bytes(inp["t_outer"][0], dev),
                              round=inp["t_outer"][1])
        (c, rx, fin), ms = _timed(lambda: SpartanSNARK.outer_sumcheck(
            F, td, ABC.clone(), inp["taus"], inp["eff"], mesh))
        out["outer_ms"].append(ms)
        if rep == 0:
            out["outer"] = [c.cpu(), rx.cpu(), torch.stack(fin).cpu(), td.state.cpu(),
                            td.round]
        td = DeviceTranscript(F, state=host_bytes(inp["t_inner"][0], dev),
                              round=inp["t_inner"][1])
        (ci, ry, ez), ms = _timed(lambda: SpartanSNARK.inner_sumcheck(
            F, td, abc.clone(), z.clone(), claim, inp["nv"], inp["ne"], mesh))
        out["inner_ms"].append(ms)
        if rep == 0:
            out["inner"] = [ci.cpu(), ry.cpu(), ez.cpu(), td.state.cpu(), td.round]
    return out


def mesh_sumcheck_rank(mesh, path: str, engine: str):
    """A rank of the sum-check mesh: the sharded outer and inner sum-checks on
    SHA-256 1 KiB's inputs (read from ``path``), with their gathers."""
    from spartan2_tpu_torch.sumcheck.device import CUBICEQ

    inp = torch.load(path, weights_only=False)
    CUBICEQ.reset()
    g0, gs0 = mesh.gathers, mesh.gather_s
    out = run_sumchecks(inp, engine, mesh.device, mesh)
    out["gathers"] = [mesh.gathers - g0, mesh.gather_s - gs0]
    out["cubiceq_launches"] = CUBICEQ.launches
    out["gather_ms"] = {rows: _gather_ms(mesh, rows) for rows in (1, 1024)}
    return out


def check_mesh_launches(ranks) -> None:
    """Every rank's sharded proves launched the shard kernels."""
    for out in ranks:
        lz = out["spartan_launches"]
        for kname, entry in (("cubiceq", "sp2_cubiceq_evals"),
                             ("round_finish", "sp2_round_finish"),
                             ("sumcheck", "sp2_round_evals"), ("sumcheck", "sp2_bind_dev"),
                             ("sumcheck", "sp2_inner0_evals"), ("spmv", "sp2_spmv"),
                             ("comb", "sp2_comb_rows"), ("hyrax_bind", "sp2_hyrax_bind")):
            if lz[kname].get(entry, 0) <= 0:
                raise RuntimeError(f"mesh: {kname}.{entry} not launched by the sharded "
                                   "SpartanSNARK prove")
        ln = out["nn_launches"]
        for kname, entry in (("sumcheck", "sp2_round_evals"), ("sumcheck", "sp2_bind"),
                             ("nifs", "sp2_nifs_round")):
            if ln[kname].get(entry, 0) <= 0:
                raise RuntimeError(f"mesh: {kname}.{entry} not launched by the sharded "
                                   "NN prove")
        if out["commit_launches"] <= 0:
            raise RuntimeError("mesh: commit_rows_sharded launched no comb kernel")


def run_mesh(pk, prep, nn_pk, blobs: dict, cfg: dict = MAIN_CFG):
    """The mesh phase on the configurations ``cfg`` of ``pk``, ``prep``,
    ``nn_pk`` and the single-device proofs ``blobs`` -> (kernel records,
    detail records)."""
    import tempfile

    from spartan2_tpu_torch.ec.comb import comb_rows, comb_rows_plain
    from spartan2_tpu_torch.field.limbs import limbs_to_ints, to_device
    from spartan2_tpu_torch.parallel.mesh import run_ranks
    from spartan2_tpu_torch.pcs.hyrax import SMALL_BITS
    from spartan2_tpu_torch.polys.eq import eq_evals_host
    from spartan2_tpu_torch.sumcheck.device import (CUBIC, QUAD, cubiceq_evals,
                                                    cubiceq_evals_plain, new_ticket,
                                                    round_evals_batched,
                                                    round_evals_batched_plain)

    engine, S, dev = pk.engine, pk.S, pk.device
    F = engine.scalar
    p = F.modulus
    phases = {}

    # (m1) SpartanSNARK and NeutronNova on MESH_W ranks, against this run's
    # single-device proofs from the same seeds
    t0 = time.perf_counter()
    ranks = run_ranks(mesh_snark_rank, MESH_W, (cfg,), device=dev, timeout=MESH_DEADLINE)
    phases["snark_ranks_s"] = time.perf_counter() - t0
    for out in ranks:
        for name in ("spartan", "nn"):
            if out[name] != blobs[name]:
                raise RuntimeError(f"mesh: rank {out['rank']}'s {name} proof differs from "
                                   "the single-device proof")
    check_mesh_launches(ranks)
    if not (ranks[1]["spartan_verifies"] and ranks[1]["nn_verifies"]):
        raise RuntimeError("mesh: a mesh proof does not verify")
    print(f"mesh: {MESH_W} ranks ({ranks[0]['backend']}) on one card: SpartanSNARK "
          f"SHA-256 1 KiB proof equal to the single-device proof "
          f"({len(blobs['spartan'])} bytes) and verified; NeutronNova {cfg['nn_steps']} steps "
          f"equal ({len(blobs['nn'])} bytes) and verified", flush=True)
    # the precommitted witness's rows, committed row-sharded and whole
    wit = prep.ps.W[S.num_shared : S.num_shared + S.num_precommitted]
    scp = to_device(wit, F, dev).reshape(-1, S.width, 8)
    comb = pk.ck.comb(SMALL_BITS)
    whole = comb_rows(scp, comb.table, comb.curve)
    for out in ranks:
        if not torch.equal(out["commit"], whole.cpu()):
            raise RuntimeError("mesh: commit_rows_sharded differs from comb_rows")
    print(f"mesh: commit_rows_sharded over {scp.shape[0]} rows x {scp.shape[1]} at "
          f"W = {MESH_W} equals comb_rows", flush=True)
    for key in ("spartan_setup_prep_s", "spartan_prove_s", "spartan_gathers",
                "nn_setup_prep_s", "nn_prove_s", "nn_gathers", "commit_ms", "gather_ms"):
        phases[key] = [out[key] for out in ranks]
    print("mesh launches of the ranks' first sharded proves: " + json.dumps(
        {f"rank {out['rank']}": {"spartan": out["spartan_launches"],
                                 "nn": out["nn_launches"],
                                 "commit": out["commit_launches"]} for out in ranks}),
          flush=True)

    # (m2) the outer and inner sum-checks at SUMCHECK_W ranks against one device
    inp = _sumcheck_inputs(pk, prep, _sha_circuit(cfg))
    single = run_sumchecks(inp, pk.engine.name, dev)
    with tempfile.TemporaryDirectory(prefix="sp2-sumchecks-") as tmp:
        path = f"{tmp}/inputs.pt"
        torch.save(inp, path)
        t0 = time.perf_counter()
        dranks = run_ranks(mesh_sumcheck_rank, SUMCHECK_W, (path, pk.engine.name),
                           device=dev, timeout=MESH_DEADLINE)
        phases["sumcheck_ranks_s"] = time.perf_counter() - t0
    for out in dranks:
        for name in ("outer", "inner"):
            if not all((torch.equal(a, b) if isinstance(a, torch.Tensor) else a == b)
                       for a, b in zip(out[name], single[name])):
                raise RuntimeError(f"mesh: the sharded {name} sum-check differs from the "
                                   "single-device prover")
    phases["single_outer_ms"], phases["single_inner_ms"] = (single["outer_ms"],
                                                            single["inner_ms"])
    for key in ("outer_ms", "inner_ms", "gathers", "gather_ms"):
        phases[f"sharded_{key}"] = [out[key] for out in dranks]
    m = len(inp["taus"])
    print(f"mesh: the sharded outer (2^{m}, peeled) and inner sum-checks at W = "
          f"{SUMCHECK_W} equal the single-device provers (coefficients, challenges, "
          "finals, state)", flush=True)

    # (m3) kernel G's strided mode at the sum-check mesh's shard shape, s = 0
    # and s = W - 1, against its plain version on the card
    taus, eff = inp["taus"], inp["eff"]
    fh, lw, n = m // 2, SUMCHECK_W.bit_length() - 1, 1 << m
    EL = to_device(eq_evals_host(F, taus[1:fh]), F, dev, mont=True)
    ER = to_device(eq_evals_host(F, taus[fh:]), F, dev, mont=True)
    ABC = inp["ABC"].to(dev)
    half_loc, hi_len = n // 2 // SUMCHECK_W, eff - n // 2
    out_k, detail = [], []
    for s in (0, SUMCHECK_W - 1):
        loc = [v[:n][s::SUMCHECK_W].contiguous() for v in ABC]
        live = min(half_loc, max(0, -(-(hi_len - s) // SUMCHECK_W)))
        args = (half_loc, live, EL, ER, m - fh, True, False, F, s, lw)
        got = cubiceq_evals(*loc, *args)
        want, pms = once_ms(lambda: cubiceq_evals_plain(*loc, *args))
        gs = [sum(col) % p for col in zip(*[limbs_to_ints(b, F, mont=True)
                                            for b in got.cpu()])]
        if gs != limbs_to_ints(want[0], F, mont=True):
            raise RuntimeError(f"kernel G (shard {s} of {SUMCHECK_W}) differs from its plain "
                               "version")
        print(f"equal to plain: cubiceq_evals strided (peeled round 0, shard {s} of "
              f"{SUMCHECK_W}, {half_loc} local pairs, {live} live)", flush=True)
    g_launches = sum(out["spartan_launches"]["cubiceq"].get("sp2_cubiceq_evals", 0)
                     for out in ranks)
    ticket = new_ticket(dev)

    def strided():
        cubiceq_evals(*loc, *args, ticket=ticket)

    rec = kernel_record(
        "cubiceq_strided", "spartan2_tpu/parallel/sumcheck_shard.py:199", g_launches,
        f"sp2_cubiceq_evals calls of the {MESH_W} ranks' sharded SpartanSNARK prove",
        cuda_ms(strided, 10), pms,
        2 * (half_loc + live) * 32 + (EL.shape[0] + ER.shape[0]) * 32
        + 3 * 32 * got.shape[0], g_muls(half_loc, 1 << max(0, m - fh - lw), 1),
        source="spartan2_tpu_torch/csrc/cubiceq.cu")
    rec["device_ms"] = device_ms(strided, 10)
    out_k.append(rec)

    # (m4) the other kernels at the shard shapes of the MESH_W mesh: kernel
    # A QUAD over an inner shard, kernel A CUBIC over NN's outer shard
    # (K = 2), comb rows over a rank's rows
    gen = torch.Generator().manual_seed(9)

    def shard_plain(name, mode, rows, vecs) -> float:
        """Kernel A's sums against its plain version -> the plain ms."""
        want, ms = once_ms(lambda: round_evals_batched_plain(mode, rows, vecs, F))
        same_or_raise(name, sum(round_evals_batched(mode, rows, vecs, F), []),
                      want.reshape(-1, 8), F)
        return ms

    nq = S.num_vars // MESH_W
    vq = [rand_field(nq, F, gen, dev) for _ in range(2)]
    detail.append(detail_record(
        f"shard_quad_step: round_evals quad over a W = {MESH_W} shard, {nq} rows",
        cuda_ms(lambda: round_evals_batched(QUAD, nq, vq, F), 10),
        shard_plain(f"round_evals quad (inner shard, {nq} rows)", QUAD, nq, vq),
        2 * nq * 32, nq))
    detail[-1]["device_ms"] = sums_device_ms(QUAD, nq, vq, F)
    nc = nn_pk.S_step.num_cons // MESH_W
    E = rand_field(nc, F, gen, dev)
    vk3 = [rand_field(2 * nc, F, gen, dev).reshape(2, nc, 8) for _ in range(3)]
    detail.append(detail_record(
        f"shard_zkc_evals: round_evals cubic K = 2 over a W = {MESH_W} shard, {nc} rows",
        cuda_ms(lambda: round_evals_batched(CUBIC, nc, [E, *vk3], F), 10),
        shard_plain(f"round_evals cubic K = 2 (NN outer shard, {nc} rows)", CUBIC, nc,
                    [E, *vk3]),
        (nc + 6 * nc) * 32, 2 * 6 * (nc // 2)))
    detail[-1]["device_ms"] = sums_device_ms(CUBIC, nc, [E, *vk3], F)
    ncub = S.num_cons // MESH_W
    vc4 = [rand_field(ncub, F, gen, dev) for _ in range(4)]
    detail.append(detail_record(
        f"shard_cubic_step: round_evals cubic over a W = {MESH_W} shard, {ncub} rows",
        cuda_ms(lambda: round_evals_batched(CUBIC, ncub, vc4, F), 10),
        shard_plain(f"round_evals cubic (explicit-eq shard, {ncub} rows)", CUBIC, ncub,
                    vc4),
        4 * ncub * 32, 6 * (ncub // 2)))  # per pair: A B and eq (A B - C) at 0, 2, 3
    detail[-1]["device_ms"] = sums_device_ms(CUBIC, ncub, vc4, F)
    nzq = nn_pk.S_step.num_vars // MESH_W
    vzq = [rand_field(2 * nzq, F, gen, dev).reshape(2, nzq, 8) for _ in range(2)]
    detail.append(detail_record(
        f"shard_zkq_evals: round_evals quad K = 2 over a W = {MESH_W} shard, {nzq} rows",
        cuda_ms(lambda: round_evals_batched(QUAD, nzq, vzq, F), 10),
        shard_plain(f"round_evals quad K = 2 (NN inner shard, {nzq} rows)", QUAD, nzq,
                    vzq),
        4 * nzq * 32, 2 * nzq))
    detail[-1]["device_ms"] = sums_device_ms(QUAD, nzq, vzq, F)
    # kernel A's rounds with the bind folded in, at the same shard shapes
    r_sh = random.Random(10).randrange(p)
    for name, mode, rows, vecs in (("shard_quad_step", QUAD, nq, vq),
                                   ("shard_zkc_evals K = 2", CUBIC, nc, [E, *vk3]),
                                   ("shard_cubic_step", CUBIC, ncub, vc4),
                                   ("shard_zkq_evals K = 2", QUAD, nzq, vzq)):
        ms, pms, dms = bind_first_case(
            f"{name}, bind-first over a W = {MESH_W} shard, {rows} rows", mode, rows, vecs,
            r_sh, F, 10)
        detail.append(detail_record(
            f"{name}: bind-first round over a W = {MESH_W} shard, {rows} -> {rows // 2} rows",
            ms, pms, *bind_first_bound(mode, rows, vecs)))
        detail[-1]["device_ms"] = dms
    per = scp.shape[0] // MESH_W
    mine = scp[:per].contiguous()
    want, cpms = once_ms(lambda: comb_rows_plain(mine, comb.table, comb.curve))
    same_or_raise(f"comb_rows over a rank's {per} rows", comb_rows(mine, comb.table,
                                                                  comb.curve), want, F)
    detail.append(detail_record(
        f"commit_rows_sharded: comb_rows over a rank's {per} x {S.width}",
        cuda_ms(lambda: comb_rows(mine, comb.table, comb.curve), 3), cpms,
        *comb_bound_args(mine, comb.n_win)))
    rounds = sum(g[0] for out in ranks for g in [out["spartan_gathers"]])
    gather_ms = [1e3 * out["spartan_gathers"][1] / max(1, out["spartan_gathers"][0])
                 for out in ranks]
    phases["gather_ms_per_call_spartan"] = gather_ms
    phases["gather_calls_spartan"] = rounds
    print(f"mesh ranks: {MESH_W} (SNARKs) and {SUMCHECK_W} (sum-checks), backend "
          f"{ranks[0]['backend']}, all on {dev}", flush=True)
    print("mesh phases: " + json.dumps(phases), flush=True)
    return out_k, detail


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from spartan2_tpu_torch.provider.engines import get_engine
    from spartan2_tpu_torch.utils.cuda import build_all
    from tools.curve_latency import dbl_chain_probe
    from tools.round_latency import latency_probe

    card = card_line()
    print(f"card: {card}", flush=True)
    kernels = _path_kernels()
    spartan_kernels = kernels[:-1]  # all but NIFS
    probe, f_probe = dbl_chain_probe(), latency_probe()
    print(f"build: {build_all([*kernels, probe, f_probe]):.1f} s (nvcc, {len(kernels) + 2} "
          "sources in parallel: the kernels, the ladder doubling's probe and kernel F's "
          "chains)", flush=True)
    print(f"host C build: {build_host_c():.2f} s (cc: native/keccak.c, "
          "native/ec_host.c)", flush=True)
    h_detail = check_host_curve()
    for k in kernels:
        log = k.lib_path.parent / f"{k.name}.log"
        regs = [ln.strip() for ln in log.read_text().splitlines()
                if "registers" in ln or "spill" in ln] if log.exists() else []
        print(f"ptxas {k.name}: " + " | ".join(regs[:12]), flush=True)
    for k in kernels:
        if k.name in ("cubiceq", "hyrax_bind", "nifs"):  # kernels G, 4 and NIFS 3, 4
            print(f"ptxas {k.name}: every kernel 0 bytes of stack and spills "
                  f"({len(zero_stack_or_raise(k))} kernels)", flush=True)
    dev = torch.device("cuda")
    engine = get_engine("P256HyraxEngine")
    circuit = _sha_circuit(MAIN_CFG)

    pk, prep, proof, launches, blob = run_spartan(engine, circuit, dev, spartan_kernels)
    zk_proof, zk_launches = run_spartan_zk(engine, pk.S, circuit, dev, spartan_kernels)
    nn_pk, nn_prep, nn_proof, nn_launches, nn_blob = run_neutronnova(engine, dev, kernels)
    check_golden_cubic(dev, zk=False)
    check_golden_cubic(dev, zk=True)
    for name in ("square", "precommitted"):
        check_golden_nn(dev, name)
    t_out, t_detail = check_transcript(dev, launches)
    s_out, s_detail = check_sumchecks(pk, prep, circuit, launches, f_probe)
    g_detail = check_graphs(pk, prep, circuit)
    g_detail += check_g_and_bind(dev)
    out, detail = compare_kernels(pk, prep, proof, launches)
    zk_out, zk_detail = compare_zk_kernels(pk.S, zk_proof, proof, zk_launches, launches,
                                           nn_launches)
    nn_out, nn_detail = compare_nn_kernels(nn_pk, nn_prep, nn_proof, nn_launches)
    p_detail = check_pallas(dev)
    msm_detail, floors = check_msm(dev, probe)
    for rec in out + zk_out + nn_out:
        if rec["name"] in ("msm", "msm_rows", "msm_rows_nn"):
            # 255 doublings in sequence: the floor of any shape's chain
            rec["latency_floor_ms"] = floors["latency_floor_ms"]
    f_out, f_detail = check_curve(dev)
    m_out, m_detail = run_mesh(pk, prep, nn_pk, {"spartan": blob, "nn": nn_blob})
    print("kernel details (ms, bound_ms): " + json.dumps(
        detail + zk_detail + nn_detail + t_detail + s_detail + g_detail + p_detail
        + msm_detail + f_detail + m_detail + h_detail), flush=True)
    print(json.dumps({"kernels": out + zk_out + nn_out + t_out + s_out + f_out + m_out}),
          flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
