"""The port's ground rules, checked mechanically.

* ``src/repro_torch/`` and ``chip_smoke.py`` import neither ``jax`` nor any
  module of the reference package ``repro``.
* Entry points default to the card: without CUDA they raise unless the
  caller passes ``device="cpu"``.
* The CUDA kernel wrapper's argument check refuses what the kernel cannot
  take, a block too large for one CTA's shared memory first of all.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core.device import resolve_device
from repro_torch.kernels import morph_tile
from repro_torch.morph.ops import reconstruct
from repro_torch.solve import solve

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def _imports(path: Path):
    """Every module an import statement or a literal ``import_module`` /
    ``__import__`` call in ``path`` names."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call):
            fn = node.func
            name = (fn.attr if isinstance(fn, ast.Attribute) else
                    fn.id if isinstance(fn, ast.Name) else "")
            if name in ("import_module", "__import__") and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str):
                yield node.args[0].value


def test_port_files_exist():
    assert len(PORT_FILES) > 10
    assert (ROOT / "src" / "repro_torch" / "kernels" / "csrc"
            / "morph_tile.cu").exists()


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_import_scan_catches_forbidden_modules():
    assert _forbidden("jax.numpy") and _forbidden("repro.solve")
    assert _forbidden("repro") and not _forbidden("repro_torch.solve")


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA: the default device is usable")


def test_default_device_raises_without_cuda():
    _no_card()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")


def test_solve_without_device_raises_without_cuda():
    _no_card()
    marker = np.zeros((8, 8), np.int32)
    mask = np.ones((8, 8), np.int32)
    with pytest.raises(RuntimeError):
        solve("morph", (marker, mask), engine="frontier")
    with pytest.raises(RuntimeError):
        reconstruct(marker, mask, engine="tiled-kernel")
    out, _ = solve("morph", (marker, mask), engine="frontier", device="cpu")
    assert out["J"].device == torch.device("cpu")


def test_auto_engine_and_sweeps_are_later_slices():
    marker = np.zeros((8, 8), np.int32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        solve("morph", (marker, marker), engine="auto", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        reconstruct(marker, marker, engine="frontier", n_sweeps=1,
                    device="cpu")
    with pytest.raises(ValueError):
        solve("morph", (marker, marker), engine="tiled-pallas", device="cpu")


def _blocks(block, K=2, dtype=torch.int32):
    shape = (K,) + block
    return (torch.zeros(shape, dtype=dtype), torch.zeros(shape, dtype=dtype),
            torch.ones(shape, dtype=torch.bool))


@pytest.mark.parametrize("block,conn", [((130, 130), 8), ((133, 133), 4),
                                        ((18, 18, 18), "conn26"),
                                        ((26, 26, 26), "conn6")])
def test_largest_tiles_fit_shared_memory(block, conn):
    morph_tile.check_kernel_args(*_blocks(block), conn)


@pytest.mark.parametrize("block,conn", [((258, 258), 8), ((134, 134), 4),
                                        ((27, 27, 27), "conn26")])
def test_tile_too_large_for_shared_memory_raises(block, conn):
    with pytest.raises(ValueError, match=str(morph_tile.SMEM_LIMIT)):
        morph_tile.check_kernel_args(*_blocks(block), conn)


@pytest.mark.parametrize("case", ["dtype", "valid", "shape", "rank",
                                  "contiguous"])
def test_kernel_argument_check_refuses(case):
    J, I, valid = _blocks((10, 10))
    if case == "dtype":
        J, I = J.to(torch.int64), I.to(torch.int64)
    elif case == "valid":
        valid = valid.to(torch.uint8)
    elif case == "shape":
        I = I[:, :9]
    elif case == "rank":
        J, I, valid = J[0], I[0], valid[0]
    else:
        J = J.transpose(1, 2)
    with pytest.raises(ValueError):
        morph_tile.check_kernel_args(J, I, valid, 8)


def test_kernel_launch_refuses_cpu_tensors():
    """The launch path takes CUDA tensors only; a CPU tensor never reaches
    the kernel (the public wrappers give it to the plain version)."""
    with pytest.raises(ValueError, match="CUDA"):
        morph_tile._launch("morph_tile_solve_batched", *_blocks((10, 10)), 8,
                           10)
