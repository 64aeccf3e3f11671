"""The port stands alone: ``repro_torch`` imports neither jax nor anything of
the reference package, and its entry points run on the card unless the
caller asks for the CPU."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"

_FORBIDDEN = re.compile(
    r"^\s*(?:import\s+(?:jax|repro)(?:\.|\s|,|$)|from\s+(?:jax|repro)(?:\.|\s))",
    re.M)


def test_import_pulls_in_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert, repro_torch.core.perks\n"
        "import repro_torch.kernels.ops, repro_torch.kernels.stencil3d\n"
        "import repro_torch.exec.planner, repro_torch.core.perf_model\n"
        "import repro_torch.sparse, repro_torch.solvers.cg\n"
        "import repro_torch.exec.precision, repro_torch.kernels.cg_fused\n"
        "import repro_torch.kernels.spmv_ell, repro_torch.kernels.spmv_sell\n"
        "import repro_torch.exec.krylov, repro_torch.kernels.krylov_fused\n"
        "import repro_torch.configs, repro_torch.configs.registry\n"
        "from repro_torch.configs import registry\n"
        "for arch in registry.ARCHS: registry.get_config(arch)\n"
        "import repro_torch.nn.param, repro_torch.nn.layers\n"
        "import repro_torch.nn.rope, repro_torch.nn.attention\n"
        "import repro_torch.models.transformer, repro_torch.models.lm\n"
        "import repro_torch.runtime.server, repro_torch.launch.serve\n"
        "import repro_torch.exec.ml, repro_torch.kernels.ssm_scan\n"
        "import repro_torch.kernels.decode_attn, repro_torch.kernels.vdot\n"
        "import repro_torch.obs, repro_torch.obs.metrics\n"
        "import repro_torch.obs.trace, repro_torch.obs.ledger\n"
        "import repro_torch.exec.batch, repro_torch.exec.executor\n"
        "import repro_torch.runtime.solver_service\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'repro' or m.startswith('repro.')]\n"
        "print(bad)\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_source_has_no_jax_or_reference_import():
    files = sorted(PORT.rglob("*.py"))
    assert files
    offenders = [str(f.relative_to(REPO)) for f in files
                 if _FORBIDDEN.search(f.read_text())]
    assert not offenders, offenders


def test_chip_smoke_has_no_jax_or_reference_import():
    script = REPO / "chip_smoke.py"
    assert not _FORBIDDEN.search(script.read_text())
    assert "repro_torch" in script.read_text()


def test_scan_pattern_catches_the_forbidden_forms():
    for line in ("import jax", "import jax.numpy as jnp", "from jax import lax",
                 "from repro.kernels import common", "import repro.exec",
                 "    from repro import obs"):
        assert _FORBIDDEN.search(line), line
    for line in ("import repro_torch", "from repro_torch.exec import plan",
                 "import jaxlib_free_name_torch"):
        assert not _FORBIDDEN.search(line), line


def test_cg_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch import CGProblem
    from repro_torch.convert import ell_from_reference
    from repro_torch.solvers.cg import load_dataset, load_sell
    data = np.eye(4, dtype=np.float32)
    cols = np.tile(np.arange(4, dtype=np.int32)[:, None], (1, 4))
    b = np.ones(4, np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CGProblem.from_ell(data, cols, b, 3)
    for call in (lambda: load_dataset("poisson2d_small"),
                 lambda: load_sell("poisson2d_small"),
                 lambda: ell_from_reference((data, cols))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    p = CGProblem.from_ell(data, cols, b, 3, device="cpu")
    assert p.b.device.type == "cpu" and p.data.device.type == "cpu"


def test_krylov_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch import BiCGStabProblem, GMRESProblem
    data = np.eye(4, dtype=np.float32)
    cols = np.tile(np.arange(4, dtype=np.int32)[:, None], (1, 4))
    b = np.ones(4, np.float32)
    for cls in (BiCGStabProblem, GMRESProblem):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls.from_ell(data, cols, b, 3)
        p = cls.from_ell(data, cols, b, 3, device="cpu")
        assert p.b.device.type == "cpu" and p.data.device.type == "cpu"


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch import StencilProblem
    from repro_torch.convert import domain_from_numpy
    from repro_torch.kernels.common import get_spec
    x = np.zeros((16, 16), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StencilProblem(x, get_spec("2d5pt"), 3)
    with pytest.raises(RuntimeError):
        domain_from_numpy(x)
    p = StencilProblem(x, get_spec("2d5pt"), 3, device="cpu")
    assert p.x.device.type == "cpu"


def test_ml_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch import SSMScanProblem
    from repro_torch.convert import params_from_reference
    from repro_torch.launch import serve
    x = np.zeros((8, 2, 4), np.float32)
    args = (x, np.ones((8, 2), np.float32), -np.ones(2, np.float32),
            np.zeros((8, 3), np.float32), np.zeros((8, 3), np.float32),
            np.zeros(2, np.float32))
    for call in (lambda: SSMScanProblem(*args),
                 lambda: params_from_reference({"w": x}),
                 lambda: serve.main(["--arch", "qwen2-0.5b", "--smoke"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    p = SSMScanProblem(*args, device="cpu")
    assert p.x.device.type == "cpu"
