"""srbx_torch's package boundary: no jax at import, the kernel build's
errors, the fused-IPM wrapper's input checks, the branches of the cycle that
are not ported, and the state conversion between the two packages."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from srbx import mpc as jmpc
from srbx import refplan as jrefplan
from srbx.config import MpcConfig, QpConfig
from srbx_torch import convert, mpc, mpc_batch, refplan
from srbx_torch.ops import _build, qp_fused

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
MODULES = ["srbx_torch", "srbx_torch.config", "srbx_torch.models.lip",
           "srbx_torch.ops.bezier", "srbx_torch.ops.qp_fused",
           "srbx_torch.ops._build",
           "srbx_torch.refplan", "srbx_torch.ocp", "srbx_torch.sqp",
           "srbx_torch.mpc", "srbx_torch.mpc_batch", "srbx_torch.convert"]


def test_import_pulls_in_no_jax():
    code = ("import importlib, sys\n"
            f"for m in {MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print(sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('jax', 'jaxlib')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    for var in ("CUDA_HOME", "CUDA_PATH"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    assert not (tmp_path / "build").exists()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    first = _build.library_path()
    assert first.parent == _build.BUILD_DIR and first.suffix == ".so"
    assert "qp_fused.cu" in [s.name for s in _build.sources()]
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "qp_fused.cu").write_text(
        (_build.CSRC_DIR / "qp_fused.cu").read_text() + "\n// edited\n")
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    assert _build.library_path().name != first.name


def _qp(n=13, mi=28, bsz=5, dtype=torch.float64):
    return (torch.eye(n, dtype=dtype)[:, :, None].repeat(1, 1, bsz),
            torch.zeros(n, bsz, dtype=dtype),
            torch.zeros(mi, n, bsz, dtype=dtype),
            torch.ones(mi, bsz, dtype=dtype))


@pytest.mark.parametrize("bad,error", [
    (lambda P, c, G, h: _qp(n=12), ValueError),                 # n != 13
    (lambda P, c, G, h: _qp(mi=65), ValueError),                # mi > 64
    (lambda P, c, G, h: _qp(dtype=torch.float16), TypeError),
    (lambda P, c, G, h: (P, c, G.transpose(0, 2).contiguous()
                         .transpose(0, 2), h), ValueError),     # strided
    (lambda P, c, G, h: (P, c.float(), G, h), TypeError),       # mixed dtype
    (lambda P, c, G, h: (P[:, :, :4], c, G, h), ValueError),    # shapes
    (lambda P, c, G, h: tuple(t.to("meta") for t in (P, c, G, h)),
     ValueError),                                               # device
], ids=["n", "mi", "dtype", "contiguous", "mixed_dtype", "shape", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, error):
    with pytest.raises(error):
        qp_fused.solve_lanes_last(*bad(*_qp()), QpConfig())
    assert qp_fused.solve_lanes_last.launches == 0


def test_wrapper_cpu_path_is_the_plain_version():
    P, c, G, h = _qp()
    G[0, 0] = 1.0                         # x_0 <= 1 binds: c pulls it to 2
    c[0] = -2.0
    out = qp_fused.solve_lanes_last(P, c, G, h, QpConfig())
    ref = qp_fused.solve_lanes_last_plain(P, c, G, h, QpConfig())
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    np.testing.assert_allclose(out[0][0].numpy(), 1.0, atol=1e-6)
    assert out[3][2].all() and qp_fused.solve_lanes_last.launches == 0


@pytest.mark.parametrize("change", [
    dict(condensed=False), dict(backend="xla"), dict(backend="pallas"),
    dict(cfg=MpcConfig(elide_simplex=False, elide_box_rows=True)),
    dict(cfg=MpcConfig(use_sqp=False, elide_simplex=True)),
], ids=["uncondensed", "xla", "pallas", "no_elide_simplex", "no_sqp"])
def test_unported_branches_raise(change):
    kw = dict(condensed=True, backend="fused")
    cfg = change.pop("cfg", MpcConfig(use_sqp=True, elide_simplex=True,
                                      elide_box_rows=True))
    kw.update(change)
    with pytest.raises(NotImplementedError, match="M1/M4"):
        mpc_batch.run_nmpc_batch(cfg, QpConfig(), *([None] * 9), **kw)


def test_from_numpy_to_numpy_round_trip():
    rng = np.random.default_rng(0)
    jcarry = jmpc.MpcCarry(np.arange(3, dtype=np.int32), rng.normal(size=(3, 4)))
    jref = jrefplan.RefTraj(rng.normal(size=(4, 6)), rng.normal(size=(4, 6)))
    tree = {"carry": jcarry, "ref": jref, "pobs": rng.normal(size=(3, 2, 5)),
            "none": None}
    t = convert.from_numpy(tree, dtype=torch.float32)
    assert isinstance(t["carry"], mpc.MpcCarry)
    assert isinstance(t["ref"], refplan.RefTraj)
    assert t["carry"].gait_domain.dtype == torch.int32
    assert t["carry"].alpha_buffer.dtype == torch.float32
    assert t["none"] is None
    back = convert.to_numpy(convert.from_numpy(tree))
    assert isinstance(back["carry"], mpc.MpcCarry)
    for a, b in ((back["carry"].gait_domain, jcarry.gait_domain),
                 (back["carry"].alpha_buffer, jcarry.alpha_buffer),
                 (back["ref"].pr, jref.pr), (back["pobs"], tree["pobs"])):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
