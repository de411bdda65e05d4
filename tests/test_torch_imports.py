"""The port stands alone: every module of `tinynerf_tpu_torch`,
`chip_smoke.py` and the port's tools (`tools/*_torch.py`) import with jax,
optax and the JAX package unimportable, and importing a tool runs nothing;
the port's own native PNG loader (`tinynerf_tpu_torch/native`, built
into `build/`, never beside its source) decodes a generated scene exactly
as the JAX package's parser and the Pillow fallback do, PNGs of several
sizes in one split included, while a file it cannot read goes to Pillow or,
without Pillow, raises naming the file; and the port's scene writer
(`make_synthetic_scene`, no Pillow) writes the JAX fixture's files.
"""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tinynerf_tpu.data import parse_nerf_synthetic as jparse
from tinynerf_tpu.utils.fixtures import make_synthetic_scene
from tinynerf_tpu_torch import native
from tinynerf_tpu_torch.data import parse_nerf_synthetic
from tinynerf_tpu_torch.data.parsers import _load_image_rgb, _load_images
from tinynerf_tpu_torch.utils import make_synthetic_scene as port_make_synthetic_scene

REPO = Path(__file__).resolve().parents[1]

_BLOCKED_IMPORTS = """
import importlib, pkgutil, sys
for name in ("jax", "optax", "tinynerf_tpu"):
    sys.modules[name] = None  # importing them now raises ImportError
import tinynerf_tpu_torch
names = ["chip_smoke", "tinynerf_tpu_torch.__main__"] + [
    m.name for m in pkgutil.walk_packages(tinynerf_tpu_torch.__path__, "tinynerf_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import importlib.util, pathlib
tools = sorted(pathlib.Path("tools").glob("*_torch.py"))
for path in tools:  # imported as modules, so their main() does not run
    spec = importlib.util.spec_from_file_location(f"tool_{path.stem}", path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
    names.append(path.stem)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "optax", "tinynerf_tpu")
                and sys.modules[m] is not None)
assert not loaded, loaded
print(len(names))
"""


def test_port_imports_nothing_of_jax():
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 39  # every module and the nine tools were walked
    assert proc.stdout.count("\n") == 1  # no tool printed: none ran its main


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_png_scene") / "spheres"
    make_synthetic_scene(root, n_train=3, n_test=1, res=24, kind="spheres")
    return root


@pytest.mark.parametrize("bg", [(255, 255, 255), (0, 0, 0), (30, 200, 90)])
def test_native_loader_matches_jax_parser(scene, bg):
    """The port's parser (its native loader) gives the JAX parser's images,
    bit for bit, and so does the Pillow fallback; RGBA over each bg."""
    lib = native.get_lib()
    assert lib is not None, "the native loader did not build (g++ and libpng)"
    assert Path(lib._name).parent == native.BUILD_DIR
    got = parse_nerf_synthetic(scene, "train", bg_color=bg)
    ref = jparse(scene, "train", bg_color=bg)
    assert len(got.imgs) == len(ref.imgs) == 3
    for a, b in zip(got.imgs, ref.imgs):
        assert a.dtype == np.float32 and a.shape == (24, 24, 3)
        np.testing.assert_array_equal(a, b)
    meta = json.loads((scene / "transforms_train.json").read_text())
    paths = [(scene / f["file_path"]).with_suffix(".png") for f in meta["frames"]]
    for a, p in zip(got.imgs, paths):
        np.testing.assert_array_equal(a, _load_image_rgb(p, bg))
    assert native.load_images([scene / "missing.png"], (1.0, 1.0, 1.0)) is None


@pytest.mark.parametrize("kind", ["blob", "spheres"])
def test_make_synthetic_scene_matches_jax(tmp_path, kind):
    """Every split's `transforms_*.json` equal, and every PNG decoding to
    the JAX fixture's pixels (Pillow reads both here)."""
    from PIL import Image

    ours = port_make_synthetic_scene(tmp_path / "ours", n_train=2, n_test=1, res=24, kind=kind)
    ref = make_synthetic_scene(tmp_path / "ref", n_train=2, n_test=1, res=24, kind=kind)
    for split in ("train", "val", "test"):
        meta = json.loads((ours / f"transforms_{split}.json").read_text())
        assert meta == json.loads((ref / f"transforms_{split}.json").read_text())
        for frame in meta["frames"]:
            a, b = (np.asarray(Image.open((root / frame["file_path"]).with_suffix(".png")))
                    for root in (ours, ref))
            assert a.shape == (24, 24, 4)
            np.testing.assert_array_equal(a, b)


def test_load_images_by_size_and_other_formats(scene, tmp_path, monkeypatch):
    """PNGs of two sizes and a JPEG in one list: each decoded as Pillow
    decodes it, in order; without Pillow the JPEG raises, naming itself."""
    from PIL import Image

    meta = json.loads((scene / "transforms_train.json").read_text())
    pngs = [(scene / f["file_path"]).with_suffix(".png") for f in meta["frames"]]
    small = tmp_path / "small.png"
    Image.open(pngs[0]).resize((10, 7)).save(small)
    jpg = tmp_path / "view.jpg"
    Image.open(pngs[1]).convert("RGB").save(jpg)
    paths = [pngs[0], small, jpg, pngs[2]]
    got = _load_images(paths, (30, 200, 90))
    assert [a.shape for a in got] == [(24, 24, 3), (7, 10, 3), (24, 24, 3), (24, 24, 3)]
    for a, p in zip(got, paths):
        np.testing.assert_array_equal(a, _load_image_rgb(p, (30, 200, 90)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert len(_load_images([pngs[0], small], (255, 255, 255))) == 2  # PNGs need no Pillow
    with pytest.raises(RuntimeError, match="view.jpg"):
        _load_images(paths, (255, 255, 255))
