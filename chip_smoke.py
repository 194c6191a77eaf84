"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

1. Prints the card's name and power limit, builds the five CUDA kernels
   from spartan2_tpu_torch/csrc/ (one nvcc per source, in parallel).
2. Drives the main path: SpartanSNARK setup, prep_prove, a warm-up prove
   and three timed proves on SHA-256 over a 1 KiB preimage
   (P256HyraxEngine, Hyrax width 2048, is_small=True), then verifies the
   proof, checks that a tampered public value is rejected and that the
   serialized proof is 94324 bytes.  Every kernel's launch count is reset
   just before setup and read after verify; each must be > 0, and each
   kernel but the verifier's MSM must be launched by every prove.  A
   count is of wrapper calls: one C entry call, which may launch more
   than one __global__ function.
3. Proves the cubic circuit on the card from the JAX package's recorded
   keys, prep state and seeds (tests/torch_golden/): the proof must equal
   the recorded JAX proof byte for byte.
4. Holds each kernel against its plain PyTorch version on the card, at the
   main path's shapes, on inputs from a fixed seed: equality is exact
   (tolerance 0: every output is an integer mod p).  Times kernel and
   plain version with CUDA events, and computes each kernel's bound from
   the bytes and 32-bit multiply-adds this run's data needs.
5. Prints one JSON line with the kernels, then the card, then
   {"ok": true, ...} as the last line.  Any failed check raises.
"""

from __future__ import annotations

import json
import random
import subprocess
import sys
import time

import torch

# Published H100 SXM rates (NVIDIA data sheet; see PERF.md): HBM bandwidth,
# and 32-bit integer multiply-adds: 64 lanes per SM (half the 128 FP32
# lanes behind the 67 TFLOP/s FP32 figure) x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
# A Montgomery product on 8 x 32-bit limbs: 64 partial products for a*b
# and 64 for the reduction, each a 64-bit result (lo and hi multiply-add).
IMAD_PER_MONT_MUL = 256
MONT_MULS_PER_ADD = 16  # complete Jacobian addition (csrc/comb.cu pt_add)
MONT_MULS_PER_DBL = 10
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


def bound_ms(nbytes: float, mont_muls: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = mont_muls * IMAD_PER_MONT_MUL / IMAD_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rand_field(n: int, spec, gen: torch.Generator, device) -> torch.Tensor:
    """n canonical elements below p (uniform below 2^(bits-1)), (n, 8)."""
    x = torch.randint(0, 1 << 32, (n, 8), generator=gen, dtype=torch.int64)
    top = spec.modulus.bit_length() - 1 - 224
    x[:, 7] &= (1 << top) - 1
    x = torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)
    return x.to(device)


def check_golden_cubic(dev) -> None:
    """Prove the cubic circuit on the card from the JAX package's recorded
    keys, prep state and seeds (tests/torch_golden/); the proof must equal
    the recorded JAX proof byte for byte."""
    from spartan2_tpu_torch.provider.engines import get_engine
    from spartan2_tpu_torch.snark.spartan import SpartanSNARK
    from spartan2_tpu_torch.utils.serde import (
        spartan_keys_from_bytes, spartan_prep_from_bytes, spartan_proof_to_bytes)
    from tests.torch_golden.make_golden import read_golden
    from tests.torch_helpers import CubicCircuit

    golden = read_golden()
    engine, circuit = get_engine("P256HyraxEngine"), CubicCircuit()
    pk, vk = spartan_keys_from_bytes(golden["keys"], engine, device=dev)
    prep = spartan_prep_from_bytes(golden["prep"], engine, pk, circuit)
    proof, _ = SpartanSNARK.prove(pk, circuit, prep, rng=det(golden["prove_seed"]))
    if spartan_proof_to_bytes(proof, engine) != golden["proof"]:
        raise RuntimeError("cubic proof on the card differs from the JAX proof")
    if SpartanSNARK.verify(proof, vk) != [15]:
        raise RuntimeError("cubic proof on the card does not verify")
    print("cubic circuit on the card: proof equals the recorded JAX proof "
          f"({len(golden['proof'])} bytes) and verifies", flush=True)


def gathered(mats) -> int:
    """Distinct entries of the input vector that SpMVs over ``mats`` read."""
    return int(torch.unique(torch.cat([m.indices for m in mats])).numel())


def compare_kernels(pk, prep, proof, launches: dict):
    """Each kernel against its plain version at the main path's shapes;
    -> (kernel records for the JSON line, detail records)."""
    from spartan2_tpu_torch.ec.comb import (
        comb_build, comb_build_plain, comb_rows, comb_rows_plain, n_windows,
        scalar_digits)
    from spartan2_tpu_torch.ec.msm import (
        MSM_WINDOW_BITS, msm, msm_plain, msm_windows, to_jacobian)
    from spartan2_tpu_torch.field.limbs import limbs_to_ints, to_device
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
    F, Fb = engine.scalar, curve.base
    dev = pk.device
    gen = torch.Generator().manual_seed(0)
    rr = random.Random(5).randrange(F.modulus)
    out, detail = [], []

    def check(name, got, plain):
        """Kernel output ``got`` against plain() -> plain milliseconds."""
        want, ms = once_ms(plain)
        if isinstance(got, list):
            same = got == limbs_to_ints(want, F, mont=True)
        else:
            same = torch.equal(got, want)
        if not same:
            raise RuntimeError(f"{name}: kernel differs from its plain version")
        print(f"equal to plain: {name}", flush=True)
        return ms

    # Bounds count what the function needs for this run's data: each input
    # entry it reads once (for an SpMV, the vector entries its columns
    # gather, not the whole vector), each output once, and the Montgomery
    # products of the additions and doublings it must do.
    def record_kernel(name, replaces, ms, plain_ms, nbytes, muls):
        b, by = bound_ms(nbytes, muls)
        out.append({"name": name, "route": "cuda",
                    "source": f"spartan2_tpu_torch/csrc/{name}.cu",
                    "replaces": replaces, "launches": launches[name],
                    "max_abs_err": 0, "ms": ms, "plain_ms": plain_ms,
                    "bound_ms": b, "bound_by": by, "library_ms": None})

    def record_detail(name, ms, plain_ms, nbytes, muls):
        b, by = bound_ms(nbytes, muls)
        detail.append({"name": name, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": b, "bound_by": by})

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
    pms = check("spmv_combine (shape_abc)", spmv_combine(tmats, eqv, rr, F),
                lambda: spmv_combine_plain(tmats, eqv, rr, F))
    tnnz = sum(m.indices.shape[0] for m in tmats)
    record_detail("spmv_combine poly_ABC",
                  cuda_ms(lambda: spmv_combine(tmats, eqv, rr, F), 10), pms,
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

    # kernel 2: eq table, and one outer round (evaluations + bind) at 2^m
    n = S.num_cons
    m = n.bit_length() - 1
    fac = eq_factors([random.Random(7 + j).randrange(F.modulus) for j in range(m)],
                     F, dev)
    eq_pms = check("eq_table", eq_table(fac, F), lambda: eq_table_plain(fac, F))
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

    # one outer round: evaluations, then the bind of all four vectors in
    # place, on copies made before the clock starts (one per run)
    reps = 5
    copies = iter([[v.clone() for v in vecs] for _ in range(reps + 2)])

    def outer_round(ev, bd):
        def run():
            res = ev(CUBIC, n, vecs, F)
            bd(next(copies), n, rr, F)
            return res
        return run

    _, pms = once_ms(outer_round(round_evals_plain, bind_plain))
    record_kernel("sumcheck", "spartan2_tpu/sumcheck/fused.py:213",
                  cuda_ms(outer_round(round_evals, bind), reps), pms,
                  4 * n * 32 + 4 * (n // 2) * 32, 10 * (n // 2))
    del copies
    record_detail(f"eq_table 2^{m}", cuda_ms(lambda: eq_table(fac, F), 5), eq_pms,
                  n * 32, n * m)
    record_detail(f"round_evals quad 2^{m}",
                  cuda_ms(lambda: round_evals(QUAD, n, vecs[:2], F), 5), quad_pms,
                  2 * n * 32, n)
    record_detail(f"round_evals dot 2^{m}",
                  cuda_ms(lambda: round_evals(DOT, n, vecs[:2], F), 5), dot_pms,
                  2 * n * 32, n)
    # the verifier's MLE evaluation of A, B, C (shape_eval): two eq
    # tables, one SpMV over T_y and three dot products
    r_y = [random.Random(40 + j).randrange(F.modulus) for j in range(m)]
    r_x = [random.Random(80 + j).randrange(F.modulus) for j in range(m)]
    fnnz = S.A.nnz + S.B.nnz + S.C.nnz
    record_detail("evaluate_at (shape_eval)",
                  cuda_ms(lambda: S.evaluate_at(r_x, r_y), 3), None,
                  2 * n * 32 + fnnz * 36 + 3 * n * 32, 2 * n * m + fnnz + 3 * n)

    # kernel 3: the PCS comb rows-MSM over [LZ, d_vec] (full width)
    comb_full = pk.ck.comb(FULL_BITS)
    C = pk.ck.num_cols
    nw = comb_full.n_win
    sc = rand_field(2 * C, F, gen, dev).reshape(2, C, 8)
    pms = check("comb_rows [LZ, d_vec]", comb_rows(sc, comb_full.table, curve),
                lambda: comb_rows_plain(sc, comb_full.table, curve))
    # the work depends on the data: one table entry and one addition per
    # nonzero digit, then the row sums
    nz = int((scalar_digits(sc, nw) != 0).sum())
    record_kernel("comb", "spartan2_tpu/ec/comb.py:123",
                  cuda_ms(lambda: comb_rows(sc, comb_full.table, curve), 5), pms,
                  2 * C * 32 + nz * 96 + 2 * 96,
                  (nz + 2 * (C - 1)) * MONT_MULS_PER_ADD)
    gx = to_device([g[0] for g in pk.ck.ck], Fb, dev, mont=True)
    gy = to_device([g[1] for g in pk.ck.ck], Fb, dev, mont=True)
    nwf = n_windows(FULL_BITS)
    pms = check("comb_build", comb_build(gx, gy, nwf, curve),
                lambda: comb_build_plain(gx, gy, nwf, curve))
    # the function needs 6 doublings from one window's base to the next,
    # chained, and 62 additions per window (the kernel recomputes each
    # window's base from G_j: 6 w doublings in thread w)
    record_detail(f"comb_build {nwf} windows x {C}",
                  cuda_ms(lambda: comb_build(gx, gy, nwf, curve), 2), pms,
                  2 * C * 32 + nwf * 64 * C * 96,
                  C * (6 * (nwf - 1) * MONT_MULS_PER_DBL
                       + nwf * 62 * MONT_MULS_PER_ADD))
    rows_pre = S.num_precommitted // S.width
    small = pk.ck.comb(SMALL_BITS)
    wit = prep.ps.W[S.num_shared : S.num_shared + S.num_precommitted]
    scp = to_device(wit, F, dev).reshape(rows_pre, C, 8)
    pms = check("comb_rows precommitted witness", comb_rows(scp, small.table, curve),
                lambda: comb_rows_plain(scp, small.table, curve))
    nz = int((scalar_digits(scp, small.n_win) != 0).sum())
    record_detail(f"comb_rows {rows_pre} x {C}, {small.n_win} windows, "
                  f"{nz} nonzero digits",
                  cuda_ms(lambda: comb_rows(scp, small.table, curve), 2), pms,
                  rows_pre * C * 32 + nz * 96 + rows_pre * 96,
                  (nz + rows_pre * (C - 1)) * MONT_MULS_PER_ADD)

    # kernel 4: the PCS row bind
    R = S.num_vars // C
    L = rand_field(R, F, gen, dev)
    poly = rand_field(R * C, F, gen, dev).reshape(R, C, 8)
    pms = check("hyrax_bind", hyrax_bind(L, poly, F),
                lambda: hyrax_bind_plain(L, poly, F))
    record_kernel("hyrax_bind", "spartan2_tpu/pcs/hyrax.py:300",
                  cuda_ms(lambda: hyrax_bind(L, poly, F), 10), pms,
                  R * C * 32 + R * 32 + C * 32, R * C + C)

    # kernel 5: the verifier's fold of the proof's row commitments
    comm_W, _ = proof.U.to_regular(engine.pcs)
    rows = len(comm_W.comm)
    Lv = eq_evals_host(F, [random.Random(120 + j).randrange(F.modulus)
                           for j in range(rows.bit_length() - 1)])
    sc = to_device(Lv, F, dev)
    pts = to_jacobian(comm_W.comm, curve, dev)
    pms = check(f"msm {rows} points", msm(sc, pts, curve),
                lambda: msm_plain(sc, pts, curve))
    nw = msm_windows(FULL_BITS)
    nzd = scalar_digits(sc, nw, MSM_WINDOW_BITS) != 0  # (windows, points)
    # per point 13 additions and one doubling for its 16 multiples; per
    # window one addition per nonzero digit but the first; below the top
    # window the ladder's 4 doublings and one addition per window
    record_kernel("msm", "spartan2_tpu/ec/device.py:398",
                  cuda_ms(lambda: msm(sc, pts, curve), 5), pms,
                  rows * (32 + 96) + 96,
                  rows * (13 * MONT_MULS_PER_ADD + MONT_MULS_PER_DBL)
                  + int(nzd.sum() - nzd.any(1).sum()) * MONT_MULS_PER_ADD
                  + (nw - 1) * (4 * MONT_MULS_PER_DBL + MONT_MULS_PER_ADD))
    return out, detail


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from spartan2_tpu_torch.ec.comb import COMB
    from spartan2_tpu_torch.ec.msm import MSM
    from spartan2_tpu_torch.errors import SpartanError
    from spartan2_tpu_torch.frontend.gadgets.sha256 import Sha256Circuit
    from spartan2_tpu_torch.pcs.hyrax import HYRAX_BIND
    from spartan2_tpu_torch.provider.engines import get_engine
    from spartan2_tpu_torch.r1cs.sparse import SPMV
    from spartan2_tpu_torch.snark.spartan import SpartanSNARK
    from spartan2_tpu_torch.sumcheck.device import SUMCHECK
    from spartan2_tpu_torch.utils.cuda import build_all
    from spartan2_tpu_torch.utils.serde import spartan_proof_to_bytes
    from spartan2_tpu_torch.utils.tracing import record

    card = card_line()
    print(f"card: {card}", flush=True)
    kernels = [SPMV, SUMCHECK, COMB, HYRAX_BIND, MSM]
    prove_kernels = [k.name for k in kernels if k is not MSM]  # MSM: verify only
    print(f"build: {build_all(kernels):.1f} s (nvcc, {len(kernels)} sources in "
          "parallel)", flush=True)
    for k in kernels:
        log = k.lib_path.parent / f"{k.name}.log"
        regs = [ln.strip() for ln in log.read_text().splitlines()
                if "registers" in ln or "spill" in ln] if log.exists() else []
        print(f"ptxas {k.name}: " + " | ".join(regs[:8]), flush=True)
    dev = torch.device("cuda")

    # ---------------- main path ----------------
    engine = get_engine("P256HyraxEngine")
    circuit = Sha256Circuit(bytes(i & 0xFF for i in range(1024)))
    for k in kernels:
        k.launches = 0
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
    timed = []
    for i in range(3):
        before = {k.name: k.launches for k in kernels}
        t0 = time.perf_counter()
        proof, prep = SpartanSNARK.prove(pk, circuit, prep, is_small=True,
                                         rng=det(3 + i))
        torch.cuda.synchronize()
        timed.append(time.perf_counter() - t0)
        per_prove = {k.name: k.launches - before[k.name] for k in kernels}
    phases["prove_s"] = timed
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
    act = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        t0 = time.perf_counter()
        SpartanSNARK.prove(pk, circuit, prep, is_small=True, rng=det(7))
        torch.cuda.synchronize()
        phases["profiled_prove_s"] = time.perf_counter() - t0
    dev_us = sorted(((e.self_device_time_total, e.key, e.count)
                     for e in prof.key_averages() if e.self_device_time_total > 0),
                    reverse=True)
    phases["profiled_prove_device_ms"] = sum(t for t, _, _ in dev_us) / 1e3
    print("prove device time by kernel (ms, launches): " + json.dumps(
        [(k[:60], round(t / 1e3, 4), c) for t, k, c in dev_us[:14]]), flush=True)
    print("phases: " + json.dumps(phases), flush=True)
    for title, sp in (("setup", spans_setup), ("prep", spans_prep),
                      ("prove (traced)", spans), ("verify", spans_verify)):
        print(f"{title} spans ms: " + json.dumps(
            [("  " * d + n, round(ms, 3)) for d, n, ms in sp]), flush=True)
    print(f"launches per prove: {json.dumps(per_prove)}; main path: "
          f"{json.dumps(launches)}", flush=True)

    check_golden_cubic(dev)
    out, detail = compare_kernels(pk, prep, proof, launches)
    print("kernel details (ms, bound_ms): " + json.dumps(detail), flush=True)
    print(json.dumps({"kernels": out}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
