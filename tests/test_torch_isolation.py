"""The port stands apart from the JAX package and runs where it is asked to.

* No module of ``repro_torch``, no ``examples/torch_*.py`` and not
  ``chip_smoke.py`` imports JAX, the JAX package ``repro`` or
  ``ml_dtypes`` (only the parity tests import both packages; the card's
  machine has no ``ml_dtypes``).
* Entry points run on a CUDA device unless the caller passes
  ``device="cpu"``; on a host without one they raise instead of quietly
  running on the CPU. That holds for the streamed path too: the double
  buffer (``core/streaming.py``) and a streamed search over a host store.
* The kernel modules import without ``nvcc``: the CUDA library is built at
  its first launch, never at import.
"""
from __future__ import annotations

import ast
import importlib
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return (sorted(PORT.rglob("*.py")) + sorted((ROOT / "examples").glob("torch_*.py"))
            + [ROOT / "chip_smoke.py"])


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _forbidden(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            if _forbidden(node.module):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_every_port_module_imports_without_jax():
    """Import the whole package in a fresh interpreter that cannot see JAX."""
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in sorted(PORT.rglob("*.py"))]
    mods = [m.removesuffix(".__init__") for m in mods]
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in ('jax', 'jaxlib', 'repro', 'ml_dtypes'):\n"
        "            raise ImportError('blocked: ' + name)\n"
        "sys.meta_path.insert(0, Block())\n"
        f"import importlib\nfor m in {mods!r}: importlib.import_module(m)\n"
        "from repro_torch.kernels import build\n"
        "assert build._lib is None\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""},
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_engine_without_device_needs_cuda():
    from repro_torch import ExactKNN

    if torch.cuda.is_available():
        assert ExactKNN(k=1).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ExactKNN(k=1)
    assert ExactKNN(k=1, device="cpu").device.type == "cpu"


def test_convert_without_device_needs_cuda():
    """The state carried from the JAX package lands on the CUDA device too,
    unless the caller asks for the CPU."""
    import numpy as np

    from repro_torch.convert import padded_from_numpy

    v, n = np.zeros((4, 2), np.float32), np.zeros(4, np.float32)
    if torch.cuda.is_available():
        assert padded_from_numpy(v, n, 4).vectors.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            padded_from_numpy(v, n, 4)
    assert padded_from_numpy(v, n, 4, device="cpu").vectors.device.type == "cpu"


def test_kernel_module_imports_without_nvcc():
    mod = importlib.import_module("repro_torch.kernels.knn.kernel")
    build = importlib.import_module("repro_torch.kernels.build")
    assert mod.LAUNCHES.keys() == {"knn_scan", "knn_merge", "knn_int8_scan", "topk", "l2dist"}
    assert build.CSRC.is_dir()
    for src in ("knn.cu", "topk.cu", "l2dist.cu", "ring.cuh", "bitonic.cuh"):
        assert (build.CSRC / src).is_file()
    assert build.BUILD_DIR == ROOT / "build" / "repro_torch"


def test_int8_state_without_device_needs_cuda():
    """The int8 codes carried from the JAX package land on the CUDA device
    too, unless the caller asks for the CPU."""
    import numpy as np

    from repro_torch.convert import quantized_from_numpy

    arrays = (np.zeros((4, 2), np.int8),) + (np.ones(4, np.float32),) * 4
    if torch.cuda.is_available():
        assert quantized_from_numpy(*arrays).q.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            quantized_from_numpy(*arrays)
    got = quantized_from_numpy(*arrays, device="cpu")
    assert got.q.dtype == torch.int8 and got.scales.device.type == "cpu"
    with pytest.raises(ValueError, match="int8"):
        quantized_from_numpy(np.zeros((4, 2), np.float32), *arrays[1:], device="cpu")


def test_streaming_modules_stand_alone():
    """The double buffer and the host store import neither JAX nor the JAX
    package (checked on the source: their imports, not what they reach)."""
    for rel in ("core/streaming.py", "store/store.py", "core/fqsd.py", "convert.py"):
        tree = ast.parse((PORT / rel).read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module]
        assert not [m for m in names if _forbidden(m)], rel
        assert any(m.startswith("torch") for m in names), rel


def test_streamed_search_without_device_needs_cuda():
    """A streamed search on an engine built with device=None runs on the
    card, and raises where there is none; the double buffer likewise."""
    import numpy as np

    from repro_torch import ExactKNN, SearchRequest
    from repro_torch.core.streaming import DoubleBufferedStream
    from repro_torch.store import DatasetStore

    x = np.arange(600, dtype=np.float32).reshape(200, 3)
    store = DatasetStore.from_array(x, rows_per_shard=128)
    if torch.cuda.is_available():
        eng = ExactKNN(k=2, backend="cuda").fit_store(store, resident=False)
        res = eng.search(SearchRequest(queries=x[:2]))
        assert res.topk.scores.device.type == "cuda" and store.is_pinned
        assert DoubleBufferedStream([x]).__class__ is DoubleBufferedStream
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            ExactKNN(k=2, backend="cuda").fit_store(store, resident=False)
        with pytest.raises(RuntimeError, match="CUDA"):
            DoubleBufferedStream([x])
    eng = ExactKNN(k=2, backend="cuda", device="cpu").fit_store(store, resident=False)
    res = eng.search(SearchRequest(queries=x[:2]))
    assert res.plan.executor == "fqsd-mmap-streamed" and res.topk.indices.tolist() == [[0, 1],
                                                                                      [1, 0]]


@pytest.mark.parametrize("rel", ["faults.py", "store/manifest.py", "store/journal.py"])
def test_store_read_side_keeps_its_own_copies(rel):
    """The fault layer, the manifest and the journal are the port's own
    copies of modules the reference also keeps free of JAX: stdlib and
    numpy only, and not the reference's objects."""
    tree = ast.parse((PORT / rel).read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module]
    assert {m.split(".")[0] for m in names} <= {"__future__", "base64", "contextlib",
                                                 "dataclasses", "json", "os", "struct",
                                                 "threading", "time", "collections", "zlib",
                                                 "numpy"}, rel
    port = importlib.import_module("repro_torch." + rel.removesuffix(".py").replace("/", "."))
    assert "repro." not in port.__name__ and port.__file__.startswith(str(PORT))


def test_mesh_without_devices_needs_cuda():
    """A mesh over CUDA devices (make_mesh with devices=None, explicit
    "cuda" entries, Router.create(devices=N)) needs a card and raises where
    there is none; logical CPU positions run when the caller names them.
    The mesh modules stand alone (their imports checked on the source)."""
    from repro_torch import ExactKNN
    from repro_torch.api import Router
    from repro_torch.core.mesh import make_mesh

    for rel in ("core/mesh.py", "core/sharded.py"):
        tree = ast.parse((PORT / rel).read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
        names += [n.module for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom) and n.level == 0 and n.module]
        assert not [m for m in names if _forbidden(m)] and "torch" in names, rel
    if torch.cuda.is_available():
        mesh = make_mesh((1,), ("data",))
        assert mesh.first.type == "cuda"
        assert ExactKNN(k=1, mesh=mesh, mesh_axes=("data",)).device.type == "cuda"
    else:
        with pytest.raises(ValueError, match="CUDA devices"):
            make_mesh((1,), ("data",))
        with pytest.raises(RuntimeError, match="CUDA"):
            make_mesh((2,), ("data",), devices=["cuda:0"] * 2)
        with pytest.raises(ValueError, match="CUDA device"):
            Router().create("a", torch.zeros(8, 4), k=1, devices=1)
    mesh = make_mesh((2,), ("data",), devices=["cpu"] * 2)
    eng = ExactKNN(k=1, mesh=mesh, mesh_axes=("data",))
    assert eng.device.type == "cpu" and eng.mesh is mesh
    with pytest.raises(ValueError, match="first device"):
        ExactKNN(k=1, mesh=mesh, mesh_axes=("data",), device="meta")
