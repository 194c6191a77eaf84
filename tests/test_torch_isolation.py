"""The port imports neither JAX nor the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _forbidden(name: str) -> bool:
    return any(name == m or name.startswith(m + ".") for m in ("jax", "spartan2_tpu"))


def test_no_jax_imports_in_port_sources():
    files = sorted((ROOT / "spartan2_tpu_torch").rglob("*.py")) + [
        ROOT / "chip_smoke.py", ROOT / "tests" / "torch_mesh_worker.py"]
    assert len(files) > 20
    assert ROOT / "spartan2_tpu_torch" / "parallel" / "sumcheck_shard.py" in files
    assert ROOT / "spartan2_tpu_torch" / "frontend" / "test_shape_cs.py" in files
    bad = []
    for f in files:
        for node in ast.walk(ast.parse(f.read_text(), str(f))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{f.relative_to(ROOT)}: {n}" for n in names if _forbidden(n)]
    assert bad == []


def test_cubic_prove_runs_without_jax_or_kernels():
    code = """
import sys
from spartan2_tpu_torch.provider.engines import get_engine
from spartan2_tpu_torch.snark.spartan import SpartanSNARK
# the ZK slice's modules load without JAX too
import spartan2_tpu_torch.r1cs.multiround
import spartan2_tpu_torch.r1cs.relaxed
import spartan2_tpu_torch.snark.spartan_relaxed
import spartan2_tpu_torch.snark.spartan_zk
import spartan2_tpu_torch.snark.zk_circuits
import spartan2_tpu_torch.sumcheck.host
import spartan2_tpu_torch.sumcheck.zk_device
import spartan2_tpu_torch.utils.serde
# and NeutronNova's
import spartan2_tpu_torch.field.small_value
import spartan2_tpu_torch.snark.neutronnova
import spartan2_tpu_torch.sumcheck.nifs
# and the device transcript's and the enqueued sum-checks'
import spartan2_tpu_torch.native
import spartan2_tpu_torch.sumcheck.prove
import spartan2_tpu_torch.transcript.device
# and the multi-device path's, with the mesh tests' rank functions
import spartan2_tpu_torch.parallel.mesh
import spartan2_tpu_torch.parallel.sumcheck_shard
import tests.torch_mesh_worker
# and the host curve in C, the curve and multilinear device functions and
# the host helpers
import spartan2_tpu_torch.ec.msm
import spartan2_tpu_torch.frontend.test_shape_cs
import spartan2_tpu_torch.polys.multilinear
from tests.torch_helpers import CubicCircuit, det
engine, circuit = get_engine("P256HyraxEngine"), CubicCircuit()
pk, vk = SpartanSNARK.setup(engine, circuit, width=4, device="cpu")
prep = SpartanSNARK.prep_prove(pk, circuit, rng=det(1))
proof, _ = SpartanSNARK.prove(pk, circuit, prep, rng=det(2))
assert SpartanSNARK.verify(proof, vk) == [15]
loaded = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
          or m == "spartan2_tpu" or m.startswith("spartan2_tpu.")]
assert not loaded, loaded
# the prove's host curve arithmetic ran in C
import spartan2_tpu_torch.ec.curve as curve_mod
assert curve_mod._EC is not None
# CPU tensors ran the plain versions: no kernel was built or launched
from spartan2_tpu_torch.ec.comb import COMB
from spartan2_tpu_torch.ec.msm import MSM
from spartan2_tpu_torch.pcs.hyrax import HYRAX_BIND
from spartan2_tpu_torch.r1cs.sparse import SPMV
from spartan2_tpu_torch.sumcheck.device import CUBICEQ, SUMCHECK
from spartan2_tpu_torch.sumcheck.nifs import NIFS
from spartan2_tpu_torch.sumcheck.prove import ROUND_FINISH
from spartan2_tpu_torch.transcript.device import TRANSCRIPT
for k in (SPMV, SUMCHECK, COMB, HYRAX_BIND, MSM, NIFS, CUBICEQ, ROUND_FINISH, TRANSCRIPT):
    assert k.launches == 0 and k._lib is None, k.name
print("isolated")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "isolated" in out.stdout


def test_host_multilinear_loads_no_kernel_layer():
    """polys/multilinear.py's host evaluations, which every SNARK and
    verifier imports, load neither torch nor the sum-check kernels; its
    device functions import kernel 2 when called."""
    code = """
import sys
from spartan2_tpu_torch.field.constants import get_field
from spartan2_tpu_torch.polys.multilinear import mle_evaluate_host, sparse_poly_evaluate_host
F = get_field("p256_scalar")
assert mle_evaluate_host(F, [1, 2, 3, 4], [0, 1]) == 2
assert sparse_poly_evaluate_host(F, 2, [1, 2], [0, 1]) == 2
loaded = [m for m in ("torch", "spartan2_tpu_torch.sumcheck.device") if m in sys.modules]
assert not loaded, loaded
print("host only")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "host only" in out.stdout
