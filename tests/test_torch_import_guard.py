"""The PyTorch port stands alone: it imports neither jax nor the JAX package
``repro``, builds nothing at import, and never falls back to the CPU
quietly."""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import device as port_device  # noqa: E402
from repro_torch.compressors.snapshots import (  # noqa: E402
    DeltaSnapshotArchive,
    SnapshotArchive,
)
from repro_torch.compressors.szlike import sz_compress, sz_decompress  # noqa: E402
from repro_torch.convert import archive_from_arrays  # noqa: E402
from repro_torch.core.refactor import METHODS, refactor_variables  # noqa: E402
from repro_torch.kernels.bitplane_pack import bitplane_pack  # noqa: E402
from repro_torch.kernels.bitplane_unpack import bitplane_unpack  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "src" / "repro_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO / "src").with_suffix("").parts)
        .replace(".__init__", "")
        for p in PKG.rglob("*.py"))


def test_every_module_imports_without_jax_repro_or_triton():
    mods = _modules()
    assert "repro_torch.core.retrieval" in mods
    assert "repro_torch.compressors.szlike" in mods
    assert "repro_torch.compressors.snapshots" in mods
    for m in ("models.config", "models.layers", "models.transformer",
              "models.moe", "models.ssm",
              "data.batches", "train.pytree", "train.optimizer",
              "train.grad_compress", "train.train_step", "train.checkpoint",
              "train.fault", "launch.train", "configs.internlm2_1_8b",
              "configs.zamba2_2_7b"):
        assert f"repro_torch.{m}" in mods
    code = ("import sys, importlib\n"
            "for m in ('jax', 'repro', 'triton'):\n"
            "    sys.modules[m] = None\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print('imported', len(sys.modules))\n")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("imported")


FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro\b|from\s+repro\b)",
    re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*PKG.rglob("*.py"),
                                       REPO / "chip_smoke.py",
                                       REPO / "examples" /
                                       "quickstart_torch.py",
                                       REPO / "examples" /
                                       "ge_case_study_torch.py",
                                       REPO / "examples" /
                                       "serve_retrieval_torch.py",
                                       REPO / "examples" /
                                       "train_lm_progressive_torch.py",
                                       REPO / "tools" / "time_bitplane.py",
                                       REPO / "tools" / "time_fma.py",
                                       REPO / "tools" / "time_thomas.py",
                                       REPO / "tools" / "time_serve.py",
                                       REPO / "tools" / "time_checkpoint.py",
                                       REPO / "tools" /
                                       "profile_train_step.py",
                                       REPO / "tools" /
                                       "profile_decode_step.py"]))
def test_no_jax_or_repro_import_statement(path):
    src = (REPO / path).read_text()
    assert not FORBIDDEN.findall(src), path


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    fields = {"P": np.linspace(1.0, 2.0, 33)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        refactor_variables(fields)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_device.resolve_device(None)
    with pytest.raises(RuntimeError):
        archive_from_arrays({"method": "hb", "variables": {}, "masks": {},
                             "ranges": {}, "shapes": {}})
    # the snapshot compressors: the predict/quantise loop wants CUDA too
    x = fields["P"]
    for method in ("psz3", "psz3_delta"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            refactor_variables(fields, method=method)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sz_compress(x, 1e-3)
    snap = sz_compress(x, 1e-3, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sz_decompress(snap)
    for cls in (SnapshotArchive, DeltaSnapshotArchive):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls.build(x, [1e-2])
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cls.build(x, [1e-2], device="cpu").open()
    # the serve plane: the server and ``python -m repro_torch.launch.serve``
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.RetrievalServer(fields)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--n", "64", "--requests", "1"])
    # the trainer and its pieces
    from repro_torch.launch import train
    from repro_torch.models.transformer import Transformer
    from repro_torch.train import checkpoint
    from repro_torch.configs import get_reduced
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--reduced", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Transformer(get_reduced("internlm2-1.8b"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        checkpoint.save_checkpoint("unused", {"w": torch.zeros(2)}, 0)
    # an explicit CPU request is honoured
    assert refactor_variables(fields, device="cpu").device.type == "cpu"
    server = serve.RetrievalServer(fields, device="cpu")
    assert server.archive.device.type == "cpu"
    server.close()
    assert sz_decompress(snap, device="cpu").device.type == "cpu"


def test_refactor_runs_every_method_on_the_cpu_and_rejects_unknown_ones():
    fields = {"P": np.linspace(1.0, 2.0, 9)}
    assert METHODS == ("hb", "ob", "ip", "psz3", "psz3_delta")
    for method in METHODS:
        archive = refactor_variables(fields, method=method, device="cpu")
        assert archive.method == method and archive.device.type == "cpu"
        data, _ = archive.open().reconstruct("P", 1e-3)
        assert data.device.type == "cpu" and data.shape == (9,)
    with pytest.raises(ValueError, match="unknown method"):
        refactor_variables(fields, method="nope", device="cpu")


def test_kernel_wrappers_refuse_other_devices():
    c = torch.zeros(64, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bitplane_pack(c, 1.0, 48)
    w = torch.zeros((1, 2), dtype=torch.int32, device="meta")
    s = torch.zeros(1, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        bitplane_unpack(w, s)


def test_importing_kernels_builds_nothing():
    from repro_torch.kernels import build
    # the loader is only reached from a CUDA launch
    assert build._loaded == {}
