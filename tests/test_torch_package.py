"""The PyTorch port as a package: its own copy of the configuration, its
independence from JAX and the JAX package, and the checks its CUDA kernel
wrapper makes before anything is built or launched."""

import ast
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import multiposenet_tpu_torch
from multiposenet_tpu import config as jax_config
from multiposenet_tpu.utils import constants as jax_constants
from multiposenet_tpu_torch import config, kernels
from multiposenet_tpu_torch.ops import column_topk, decode
from multiposenet_tpu_torch.utils import constants

PACKAGE_DIR = Path(multiposenet_tpu_torch.__file__).resolve().parent
REPO = PACKAGE_DIR.parent


@pytest.mark.parametrize("name", ["__call__", "fast", "crowd"])
def test_config_matches_jax_package(name):
    make = {"__call__": lambda c: c.Config(),
            "fast": lambda c: c.Config.fast(),
            "crowd": lambda c: c.Config.crowd()}[name]
    want = make(jax_config).to_dict()
    got = make(config).to_dict()
    assert got == want
    assert config.Config.from_json(make(jax_config).to_json()) == make(config)


def test_constants_match_jax_package():
    for name in ("IMAGENET_MEAN", "IMAGENET_STD", "FLIP_PERMUTATION",
                 "KEYPOINT_NAMES"):
        assert list(getattr(constants, name)) == list(
            getattr(jax_constants, name)), name


def _port_modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PACKAGE_DIR)],
                                              "multiposenet_tpu_torch."))


def test_every_module_imports_without_jax():
    """In a fresh interpreter where `jax`, `flax`, `optax`, `orbax`,
    `msgpack`, `multiposenet_tpu`, `cv2` and `tensorflow` cannot be
    imported, every module of the port imports."""
    modules = _port_modules()
    for name in ("infer.predictor", "infer.export", "infer.msgpack_io",
                 "ops.pose_nms", "ops.column_topk", "tools.dbench2",
                 "eval.oks", "eval.runner", "data.synthetic", "data.coco",
                 "data.loader", "utils.image_io", "utils.image_codec",
                 "utils.jpeg", "utils.visualize", "cli", "__main__",
                 "data.targets", "data.augment", "train.losses",
                 "train.steps", "train.checkpoints", "train.loop",
                 "data.masks", "data.prepare", "train.prn_train",
                 "utils.profiling", "parallel.mesh", "utils.webp",
                 "utils.vp8", "utils.vp8l"):
        assert f"multiposenet_tpu_torch.{name}" in modules
    code = (
        "import importlib, sys\n"
        "for blocked in ('jax', 'flax', 'optax', 'orbax', 'msgpack',\n"
        "                'multiposenet_tpu', 'cv2', 'tensorflow'):\n"
        "    sys.modules[blocked] = None\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "print('imported', len(sys.modules))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "imported" in proc.stdout


def test_no_source_file_names_jax():
    """No module of the port, nor chip_smoke.py, imports JAX, flax, optax,
    orbax, msgpack, the JAX package or the JAX package's benchmarks."""
    forbidden = ("jax", "flax", "optax", "orbax", "msgpack",
                 "multiposenet_tpu", "benchmarks")
    for path in [*PACKAGE_DIR.rglob("*.py"), REPO / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in forbidden, (path, n)


def _imports(tree) -> list[tuple[str, ast.AST]]:
    """(top-level module name, node) of every import in a module."""
    out = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], node) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            out.append(((node.module or "").split(".")[0], node))
    return out


def test_no_module_imports_cv2_and_tensorflow_only_when_called():
    """No module of the port, nor chip_smoke.py, imports cv2; tensorflow
    is imported only inside `infer.export.import_tf_checkpoint`, when it
    is called."""
    tf_functions = []
    for path in [*PACKAGE_DIR.rglob("*.py"), REPO / "chip_smoke.py"]:
        tree = ast.parse(path.read_text())
        for name, node in _imports(tree):
            assert name != "cv2", path
        for func in ast.walk(tree):
            if isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and any(n == "tensorflow" for n, _ in _imports(func)):
                tf_functions.append((path.name, func.name))
        top = [n for n, node in _imports(tree)
               if n == "tensorflow" and not any(
                   isinstance(f, ast.FunctionDef) and node in ast.walk(f)
                   for f in ast.walk(tree))]
        assert not top, path
    assert tf_functions == [("export.py", "import_tf_checkpoint")]


def test_kernel_sources_and_build_dir():
    assert decode.KERNEL in kernels.KERNEL_NAMES
    assert column_topk.KERNEL in kernels.KERNEL_NAMES
    for name in kernels.KERNEL_NAMES:
        assert (kernels.CSRC / f"{name}.cu").is_file(), name
    ignored = (REPO / ".gitignore").read_text().splitlines()
    rel = kernels.BUILD_DIR.relative_to(REPO).as_posix()
    assert f"{rel}/" in ignored


@pytest.mark.parametrize("case", ["dtype", "strides", "peaks", "map_size",
                                  "taps", "elements"])
def test_kernel_wrapper_validates_before_building(case, monkeypatch):
    """The wrapper refuses what the kernel does not take before it builds
    or launches anything (CPU tensors stand in for CUDA ones here): f32 or
    bf16, contiguous [K, H, W] blocks, 1..16 peaks, maps at most 512 wide,
    at most 15 taps, flat indices under 2**28."""
    monkeypatch.setattr(kernels, "load", pytest.fail)
    cfg = config.DecodeConfig()
    x = torch.zeros(2, 3, 16, 16)
    if case == "dtype":
        x, err = x.half(), TypeError
    elif case == "strides":
        x, err = torch.zeros(2, 16, 16, 3).permute(0, 3, 1, 2), ValueError
    elif case == "peaks":
        cfg, err = config.DecodeConfig(max_peaks_per_channel=17), ValueError
    elif case == "map_size":
        x, err = torch.zeros(1, 1, 4, decode.MAX_WIDTH + 1), ValueError
    elif case == "taps":
        cfg, err = config.DecodeConfig(smooth_kernel_size=17), ValueError
    else:  # on the meta device: no memory of 2**29 elements is needed
        x, err = torch.empty(1, 1, 2 ** 20, 512, device="meta"), ValueError
    with pytest.raises(err):
        decode._decode_maps_cuda(x, cfg)
    assert kernels.LAUNCHES.get(decode.KERNEL, 0) == 0


def test_kernel_wrapper_takes_any_stride_of_size_one_dims(monkeypatch):
    """A [1, 1, 3, 3] view made by permute has strides (9, 1, 3, 1): the
    stride of a size-1 dim is never used, so the wrapper goes on to build
    and launch (stopped here where it would build)."""

    class Built(Exception):
        pass

    def load(name):
        raise Built(name)

    monkeypatch.setattr(kernels, "load", load)
    x = torch.zeros(1, 3, 3, 1).permute(0, 3, 1, 2)
    assert x.stride() == (9, 1, 3, 1)
    with pytest.raises(Built):
        decode._decode_maps_cuda(x, config.DecodeConfig())


def test_even_smoothing_kernel_is_refused():
    with pytest.raises(ValueError, match="odd"):
        decode.smoothing_taps(config.DecodeConfig(smooth_kernel_size=6))
