"""The port's shards (`multiposenet_tpu_torch/data/prepare.py`) and its
`prepare` command against the JAX package's: the same npz layout and
keys; the port's shards read by the JAX `read_shards` and the JAX
package's by the port's give equal records (images decoded as
cv2.imdecode decodes them, masks as IMREAD_GRAYSCALE > 127), for the
segmentation fixture's COCO JPEGs and for synthetic PNG scenes; and the
masked records they yield batch as the JAX package batches them."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from multiposenet_tpu.data import loader as jloader
from multiposenet_tpu.data import prepare as jprepare
from multiposenet_tpu.data.synthetic import make_dataset
from multiposenet_tpu_torch import cli
from multiposenet_tpu_torch.data import loader as tloader
from multiposenet_tpu_torch.data import prepare as tprepare

from torch_port_helpers import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "images"
SEGS = FIXTURES / "annotations_segs.json"


def _assert_records_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if w[k] is None or g[k] is None:
                assert g[k] is None and w[k] is None, k
            elif isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


@pytest.fixture(scope="module")
def coco_shards(tmp_path_factory):
    root = tmp_path_factory.mktemp("shards")
    out = {}
    for name, lib in (("jax", jprepare), ("port", tprepare)):
        paths = lib.prepare_coco(SEGS, FIXTURES, root / name, shard_size=4,
                                 max_persons=8)
        out[name] = (root / name, paths)
    return out


def test_shard_layout_equals_jax(coco_shards):
    """Three shards of 4, 4 and 2 records, the same keys and arrays; only
    the PNG bytes of the masks may differ (PNG is lossless: they hold the
    same pixels)."""
    (_, jpaths), (_, tpaths) = coco_shards["jax"], coco_shards["port"]
    assert [p.name for p in jpaths] == [p.name for p in tpaths] == [
        "shard-00000.npz", "shard-00001.npz", "shard-00002.npz"]
    for jp, tp in zip(jpaths, tpaths):
        j, t = np.load(jp, allow_pickle=True), np.load(tp, allow_pickle=True)
        assert sorted(j.files) == sorted(t.files)
        for k in j.files:
            assert j[k].dtype == t[k].dtype and j[k].shape == t[k].shape, k
            if k in ("exclude_mask", "person_mask"):
                assert [len(b) > 0 for b in j[k]] == [len(b) > 0
                                                      for b in t[k]]
            else:
                np.testing.assert_array_equal(t[k], j[k], err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_coco_shards_cross_read(coco_shards, writer):
    """Each package's shards read by both packages: equal records, with
    masks where the fixture has segmentations."""
    directory = coco_shards[writer][0]
    got = list(tprepare.read_shards(directory))
    want = list(jprepare.read_shards(directory))
    _assert_records_equal(got, want)
    assert sum(r["person_mask"] is not None for r in got) == 10
    assert sum(r["exclude_mask"] is not None for r in got) == 3


def test_both_writers_give_equal_records(coco_shards):
    _assert_records_equal(list(tprepare.read_shards(coco_shards["port"][0])),
                          list(jprepare.read_shards(coco_shards["jax"][0])))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_synthetic_shards_cross_read(tmp_path, writer):
    """Synthetic records embed their image: PNG-encoded by the writer
    (cv2 in the JAX package, `image_io.encode_png` in the port); no
    segmentation, so both masks read back None."""
    records = make_dataset(5, img_h=40, img_w=56, seed=2)
    lib = jprepare if writer == "jax" else tprepare
    lib.write_shards(records, tmp_path, shard_size=2, max_persons=4)
    got = list(tprepare.read_shards(tmp_path))
    _assert_records_equal(got, list(jprepare.read_shards(tmp_path)))
    for g, rec in zip(got, records):
        np.testing.assert_array_equal(g["image"], rec["image"])
        assert g["exclude_mask"] is None and g["person_mask"] is None


def test_shard_records_batch_as_in_jax(coco_shards):
    """read_shards → make_batch with mask_stride 4: the coverage maps and
    every other key equal the JAX package's, augmentation on."""
    records = list(tprepare.read_shards(coco_shards["port"][0]))[:4]
    got = tloader.make_batch(records, 128, 8, rng=np.random.RandomState(1),
                             mask_stride=4)
    want = jloader.make_batch(records, 128, 8, rng=np.random.RandomState(1),
                              mask_stride=4)
    assert got["has_mask"].all()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_write_shards_needs_image_dir_for_files(tmp_path):
    records = [{"file_name": "a.jpg", "height": 4, "width": 4,
                "keypoints": np.zeros((0, 17, 3)), "boxes": np.zeros((0, 4)),
                "iscrowd": np.zeros(0, bool), "area": np.zeros(0)}]
    with pytest.raises(ValueError, match="image_dir"):
        tprepare.write_shards(records, tmp_path)


@pytest.mark.parametrize("source", ["coco", "synthetic"])
def test_prepare_command_runs_as_a_module(tmp_path, source):
    """`python -m multiposenet_tpu_torch prepare` prints the JAX
    package's JSON line, and its shards read back as the JAX package's
    `prepare` shards do (the JAX command in process)."""
    from multiposenet_tpu import cli as jcli

    args = (["--coco-json", str(SEGS), "--image-dir", str(FIXTURES)]
            if source == "coco" else ["--synthetic", "3"])
    proc = subprocess.run(
        [sys.executable, "-m", "multiposenet_tpu_torch", "prepare", *args,
         "--output-dir", str(tmp_path / "port"), "--shard-size", "6"],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    shards = json.loads(proc.stdout.strip().splitlines()[-1])["shards"]
    assert [Path(p).name for p in shards] == (
        ["shard-00000.npz", "shard-00001.npz"] if source == "coco"
        else ["shard-00000.npz"])
    jcli.main(["prepare", *args, "--output-dir", str(tmp_path / "jax"),
               "--shard-size", "6"])
    _assert_records_equal(list(tprepare.read_shards(tmp_path / "port")),
                          list(jprepare.read_shards(tmp_path / "jax")))


def test_prepare_command_in_process(tmp_path, capsys):
    cli.main(["prepare", "--synthetic", "2", "--output-dir", str(tmp_path),
              "--max-persons", "3"])
    out = json.loads(capsys.readouterr().out.strip())
    assert out == {"shards": [str(tmp_path / "shard-00000.npz")]}
    shard = np.load(tmp_path / "shard-00000.npz", allow_pickle=True)
    assert shard["keypoints"].shape == (2, 3, 17, 3)
