"""The port's mesh (`multiposenet_tpu_torch/parallel/mesh.py`) and the
sharded batch runner (`Predictor.make_batch_runner(mesh)`, which `eval
--batched` takes) against the JAX package's, on the CPU:
`make_mesh_for_batch` picks the device counts the JAX function picks;
`shard_batch` splits in order and refuses an uneven batch; `replicate`
copies a module's state onto each device; and the runner over meshes of
2 and 4 CPU replicas equals `batch_forward` bit for bit and the JAX
package's sharded runner over tests/test_sharding.py's eight virtual
devices on its tiny predictor (the same weights), within
tests/test_torch_predictor.py's tolerances. The gradient of the
differentiable all-reduce and training over several ranks:
tests/test_torch_ddp.py.
"""

import numpy as np
import pytest
import torch

from multiposenet_tpu.config import (
    Config, DecodeConfig, DetectorConfig, ModelConfig, PRNConfig,
)
from multiposenet_tpu.infer.predictor import Predictor as JaxPredictor
from multiposenet_tpu.parallel import mesh as jax_mesh
from multiposenet_tpu_torch.eval import runner
from multiposenet_tpu_torch.infer.predictor import Predictor
from multiposenet_tpu_torch.parallel import mesh

from torch_port_helpers import (  # noqa: F401 (one_torch_thread: autouse)
    one_torch_thread, torch_config_of,
)

CPU = torch.device("cpu")
BOX_TOL = dict(atol=2e-3, rtol=1e-5)   # tests/test_torch_predictor.py
SCORE_TOL = dict(atol=1e-5, rtol=1e-5)
KP_TOL = dict(atol=1e-3, rtol=1e-5)


@pytest.mark.parametrize("batch", range(1, 18))
def test_make_mesh_for_batch_picks_the_jax_counts(batch):
    """Eight devices: the largest count that divides the batch."""
    want = jax_mesh.make_mesh_for_batch(batch).devices.size
    assert len(mesh.make_mesh_for_batch(batch, [CPU] * 8)) == want


def test_make_mesh_takes_every_card_or_refuses(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mesh.make_mesh()
    assert mesh.make_mesh(["cpu", "cpu"]) == [CPU, CPU]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 2)
    assert mesh.make_mesh() == [torch.device("cuda", i) for i in range(4)]
    assert mesh.canonical("cuda") == torch.device("cuda", 2)


def test_backend_for_the_mesh():
    cards = [torch.device("cuda", i) for i in range(4)]
    assert mesh.backend_for(cards) == "nccl"
    assert mesh.backend_for([cards[0], cards[0]]) == "gloo"
    assert mesh.backend_for([CPU] * 4) == "gloo"


def test_shard_batch_splits_in_order_and_refuses_uneven():
    x = np.arange(24).reshape(12, 2)
    parts = mesh.shard_batch(x, [CPU] * 4)
    assert [p.tolist() for p in parts] == [x[i:i + 3].tolist()
                                           for i in range(0, 12, 3)]
    tree = mesh.shard_batch({"a": x, "b": torch.arange(12)}, [CPU] * 3)
    assert [t["b"].tolist() for t in tree] == [[0, 1, 2, 3], [4, 5, 6, 7],
                                              [8, 9, 10, 11]]
    with pytest.raises(ValueError, match="does not shard evenly"):
        mesh.shard_batch(x, [CPU] * 5)
    assert mesh.chunks(x, 2)[1].tolist() == x[6:].tolist()


def test_replicate_copies_the_state():
    module = torch.nn.Linear(3, 2)
    copies = mesh.replicate(module, [CPU, torch.device("meta")])
    assert copies[0] is module and copies[1].weight.device.type == "meta"
    assert copies[1].weight.shape == module.weight.shape


def test_without_a_group_the_reductions_are_the_identity():
    x = torch.arange(3.0, requires_grad=True)
    assert mesh.world_size() == 1 and mesh.rank() == 0
    assert mesh.all_reduce_sum(x) is x
    assert torch.equal(mesh.all_reduce_sum_(x.detach().clone()), x.detach())


# --- the sharded runner -------------------------------------------------------


def _tiny_config():
    """tests/test_sharding.py's tiny predictor config."""
    return Config(
        model=ModelConfig(backbone_width=0.25, fpn_channels=32,
                          head_channels=32),
        detector=DetectorConfig(score_threshold=0.0, max_detections=8,
                                pre_nms_top_k=100),
        prn=PRNConfig(crop_height=14, crop_width=10, hidden_units=32),
        decode=DecodeConfig(max_peaks_per_channel=4),
    )


@pytest.fixture(scope="module")
def predictors():
    jax_pred = JaxPredictor(config=_tiny_config(), image_size=128)
    port = Predictor(config=torch_config_of(_tiny_config()),
                     variables=jax_pred.variables,
                     prn_variables=jax_pred.prn_variables, image_size=128,
                     device="cpu")
    images = np.random.RandomState(0).randint(0, 255, (8, 128, 128, 3),
                                              dtype=np.uint8)
    return jax_pred, port, images


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_runner_equals_batch_forward(predictors, n):
    _, port, images = predictors
    run = port.make_batch_runner([CPU] * n)
    assert run != port.batch_forward
    got, want = run(images), port.batch_forward(images)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="shard"):
        run(images[:n + 1])


@pytest.mark.parametrize("n", [2, 4])
def test_sharded_runner_equals_the_jax_runner_on_eight_devices(predictors,
                                                               n):
    jax_pred, port, images = predictors
    want = jax_pred.make_batch_runner()(images)
    got = port.make_batch_runner([CPU] * n)(images)
    for k in want:
        assert tuple(got[k].shape) == tuple(want[k].shape), k
    np.testing.assert_array_equal(got["box_valid"].numpy(),
                                  np.asarray(want["box_valid"]))
    valid = np.asarray(want["box_valid"])
    np.testing.assert_allclose(got["boxes"].numpy()[valid],
                               np.asarray(want["boxes"])[valid], **BOX_TOL)
    np.testing.assert_allclose(got["box_scores"].numpy()[valid],
                               np.asarray(want["box_scores"])[valid],
                               **SCORE_TOL)
    np.testing.assert_allclose(got["keypoints"].numpy()[valid],
                               np.asarray(want["keypoints"])[valid],
                               **KP_TOL)


def test_batched_eval_over_a_mesh_equals_one_device(predictors):
    """`evaluate_batched` with the runner over 4 CPU replicas gives the
    one-device stats."""
    _, port, images = predictors
    out = port.batch_forward(images)
    records = []
    for i, img in enumerate(images):
        boxes = out["boxes"][i, :2].numpy()
        kps = out["keypoints"][i, :2].numpy().copy()
        kps[..., 2] = 2.0
        area = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        records.append({"image": img, "height": 128, "width": 128,
                        "boxes": boxes, "keypoints": kps, "area": area,
                        "iscrowd": np.zeros(2, bool)})
    one = runner.evaluate_batched(port, records, batch_size=8)
    four = runner.evaluate_batched(port, records, batch_size=8,
                                   mesh=[CPU] * 4)
    assert one == four


def test_chip_smoke_batch_runner_mesh_rehearses_on_cpu(monkeypatch):
    """chip_smoke.py's `batch_runner_mesh` on the CPU at 64² (batch 4),
    the mesh one CPU "card": fast() counts one B1, crowd one B3 and one
    B2 a batch on it, and the runner is `batch_forward`."""
    from multiposenet_tpu_torch import kernels
    from multiposenet_tpu_torch.config import Config
    from multiposenet_tpu_torch.infer import predictor
    from multiposenet_tpu_torch.ops import decode, kp_tail
    from multiposenet_tpu_torch.ops import image as image_ops

    from torch_port_helpers import chip_smoke_module

    smoke = chip_smoke_module()
    make_mesh = mesh.make_mesh
    monkeypatch.setattr(mesh, "make_mesh", lambda devices=None: make_mesh(
        [CPU] if devices is None else devices))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(predictor, "resolve_device",
                        lambda device: torch.device(device or "cpu"))
    plain = {name: getattr(decode, name) for name in
             ("decode_maps", "decode_maps_lanes")}

    def counting(name):
        def run(hm, config=decode.DecodeConfig()):
            kernels.count_launch(decode.LANES_KERNEL if name.endswith("lanes")
                                 else decode.route(hm, config), hm.device)
            return plain[name](hm, config)
        return run

    for name in plain:
        monkeypatch.setattr(decode, name, counting(name))
    tail = kp_tail.kp_tail_cm

    def tail_counted(*args, **kwargs):
        kernels.count_launch(kp_tail.KERNEL, args[0].device)
        return tail(*args, **kwargs)

    monkeypatch.setattr(kp_tail, "kp_tail_cm", tail_counted)
    monkeypatch.setattr(smoke, "IMAGE", 64)
    monkeypatch.setattr(smoke, "BATCH", 4)
    lines = []
    monkeypatch.setattr(smoke, "emit", lines.append)
    totals = smoke.phase_batch_runner_mesh(
        Config, predictor.Predictor, decode, kp_tail, kernels, image_ops,
        mesh, "cpu")
    assert totals == {decode.KERNEL: 3, kp_tail.KERNEL: 3,
                      decode.LANES_KERNEL: 3}
    row = lines[-1]
    assert row["phase"] == "batch_runner_mesh" and row["cards"] == 1
    assert row["fast"]["img_per_s"] > 0 and row["crowd"]["img_per_s"] > 0
