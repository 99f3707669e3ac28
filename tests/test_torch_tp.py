"""Tensor parallelism in the port (``feddat_tpu_torch/parallel/tp.py``) on the
CPU: one world of 4 ranks spawned over gloo (``tests/torch_tp_worker.py``)
runs every case, held against the JAX package's ``--tp`` on the conftest's
CPU devices and against the port's own tp=1, at tiny widths in float32.

* (a) ``tp_spec_for`` shards the tensors JAX's shards, along the transposed
  axis, on the bridged names of ViLT, ViLT-BERT and ALBEF.
* (b) The shards gather back bitwise; each rank holds half of every sharded
  kernel; ``tp_forward`` at (data=2, model=2) against JAX's: ViLT's logits
  at ``rtol=2e-5, atol=2e-6`` and ALBEF's loss at ``rtol=2e-5``
  (tests/test_tp.py).
* (c) A sequential round at (data=2, model=2) against JAX's
  ``FederatedTrainer(tp_mesh=make_tp_mesh(2, 2))`` and against the port's
  world of one: server params within JAX's own ``rtol=2e-5, atol=2e-6``
  (tests/test_tp.py), scores likewise.
* (d) ALBEF's DAT step at (data=2, model=2) against JAX's under TP: the
  loss within ``rtol=2e-5`` (one layer per tower, to keep JAX's compile short).
* (e) The SPMD engine at (client=2, data=1, model=2) against JAX's TP SPMD
  round: state and scores within ``rtol=2e-4, atol=2e-5`` / ``2e-4``
  (tests/test_tp_spmd.py).
* (f) One step each of bias, LoRA, full fine-tuning and DAT with dropout
  live at model=2 against the port's tp=1 in the same process: the loss
  (rtol 1e-6), the gradients (rtol 1e-4, atol 1e-6 of the largest), the
  parameters after the step (rtol 2e-5, atol lr/50: Adam turns the
  summation-order noise of a near-zero gradient element into up to a step
  of lr there), and every replicated trainable bitwise equal on the model
  ranks.
* (g) A TP checkpoint in JAX's full layout restores into tp=2 (bitwise the
  shards it came from) and into tp=1.
* (h) The CLI's ``--tp`` guards word for word against JAX's
  ``apply_tp_arg_guards``; ``python -m feddat_tpu_torch.cli --tp 2`` on the
  world against the CLI's world of one.

The JAX weights come from ``jax.eval_shape`` of JAX's init filled with numpy
(no JAX compile for them)."""

import contextlib
import dataclasses
import io

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util

from feddat_tpu import cli as jcli
from feddat_tpu.configs.core import AdapterSpec as JaxAdapterSpec
from feddat_tpu.configs.core import FederatedConfig as JaxFederatedConfig
from feddat_tpu.configs.core import LoraSpec as JaxLoraSpec
from feddat_tpu.configs.core import OptimizerConfig as JaxOptimizerConfig
from feddat_tpu.configs.core import PEFTMode as JaxPEFTMode
from feddat_tpu.configs.core import TrainConfig as JaxTrainConfig
from feddat_tpu.data.synthetic import SyntheticAlbefClient as JaxAlbefClient
from feddat_tpu.data.synthetic import SyntheticVQAClient as JaxClient
from feddat_tpu.federated.engine import FederatedTrainer as JaxTrainer
from feddat_tpu.federated.spmd import SPMDFederatedTrainer as JaxSPMD
from feddat_tpu.models.albef import AlbefModel as JaxAlbef
from feddat_tpu.models.vilt import TaskHeadSpec as JaxHeadSpec
from feddat_tpu.models.vilt import ViltContinualLearner as JaxVilt
from feddat_tpu.parallel import tp as jtp
from feddat_tpu.parallel.mesh import make_mesh as jax_make_mesh
from feddat_tpu_torch import cli as tcli
from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
from feddat_tpu_torch.data.synthetic import SyntheticVQAClient
from feddat_tpu_torch.federated.engine import FederatedTrainer
from feddat_tpu_torch.models.vilt import TaskHeadSpec
from feddat_tpu_torch.parallel import tp
from feddat_tpu_torch.utils import param_bridge

from conftest import TINY_VILT, tiny_batch
from test_torch_albef import LA, LQ, TINY
from test_torch_albef import port_config as albef_port_config
from test_torch_cli import smoke_argv, write_task
from test_torch_remat import random_like_init
from test_torch_vilt import port_config
from test_torch_viltbert import init_weights as viltbert_weights
from torch_tp_worker import make_model, start

LR = 5e-3
JAX_TP = dict(rtol=2e-5, atol=2e-6)  # tests/test_tp.py
JAX_TP_SPMD = dict(rtol=2e-4, atol=2e-5)  # tests/test_tp_spmd.py
# parameters after one Adam step from gradients that agree: where a gradient
# element is near zero its summation-order difference decides the step, up to
# lr in that element (as tests/test_torch_federated.py holds the engines)
ADAM = dict(rtol=2e-5, atol=LR / 50)
SEQ_HEADS = {f"cl_{i}": 16 for i in range(2)}
VQA = dict(num_train=8, num_eval=4, num_labels=16, vocab_size=TINY_VILT.vocab_size,
           text_len=TINY_VILT.max_text_len, image_size=TINY_VILT.image_size, batch_size=4,
           val_batch_size=4)
ALBEF_CLIENT = dict(task_key="c", num_train=8, num_eval=4, num_answers=8,
                    vocab_size=TINY.bert.vocab_size, question_len=LQ, answer_len=LA,
                    image_size=(32, 32), batch_size=4, seed=0)
TASK = "torch_tp_task"
# ALBEF for the step of (d): one layer per tower, so JAX's TP compile stays short
SMALL = dataclasses.replace(TINY, vision_layers=1, decoder_layers=1,
                            bert=dataclasses.replace(TINY.bert, num_layers=2, fusion_layer=1))
LIVE = dataclasses.replace(TINY_VILT, hidden_dropout=0.1, attention_dropout=0.1)
MODE_CFGS = {
    "bias": dataclasses.replace(TINY_VILT, adapter=JaxAdapterSpec()),
    "lora": dataclasses.replace(TINY_VILT, adapter=JaxAdapterSpec(),
                                lora=JaxLoraSpec(rank=4, alpha=2.0, enabled=True)),
    "full": dataclasses.replace(TINY_VILT, adapter=JaxAdapterSpec()),
    "dat": LIVE,
}


def cfg(mod, mode="DAT", num_epochs=4, **kw):
    return mod["TrainConfig"](
        peft_mode=getattr(mod["PEFTMode"], mode), optimizer=mod["OptimizerConfig"](lr=LR),
        federated=mod["FederatedConfig"](comm_rounds=1, local_epochs=1, eval_every=1),
        num_epochs=num_epochs, seed=0, **kw)


JAX = dict(TrainConfig=JaxTrainConfig, PEFTMode=JaxPEFTMode, OptimizerConfig=JaxOptimizerConfig,
           FederatedConfig=JaxFederatedConfig)
PORT = dict(TrainConfig=TrainConfig, PEFTMode=PEFTMode, OptimizerConfig=OptimizerConfig,
            FederatedConfig=FederatedConfig)


def vilt_weights(heads, cfg=TINY_VILT, seed=1):
    model = JaxVilt(cfg, {k: JaxHeadSpec(num_labels=n) for k, n in heads.items()})
    batch = tiny_batch(np.random.RandomState(0), 2)
    abstract = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), batch,
                                                 method=JaxVilt.init_all))["params"]
    return model, random_like_init(abstract, seed)


def albef_weights(cfg=TINY):
    client = JaxAlbefClient(**ALBEF_CLIENT)
    batch = next(client.train_batches(0))
    abstract = jax.eval_shape(lambda: JaxAlbef(cfg).init(
        jax.random.PRNGKey(0), batch, adapter_mode="init_all", deterministic=True))["params"]
    return random_like_init(abstract, 2)


FORWARD_BATCH = tiny_batch(np.random.RandomState(6), 4)


def albef_batch():
    return next(JaxAlbefClient(**ALBEF_CLIENT).train_batches(0))


def port_heads(heads):
    return {k: TaskHeadSpec(num_labels=n) for k, n in heads.items()}


def vqa_clients(keys):
    return [dict(task_key=k, seed=i, **VQA) for i, k in enumerate(keys)]


# ------------------------------------------------------------------ fixtures

@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp_weights")
    out = {}
    for name, (heads, make) in {
        "seq": (SEQ_HEADS, lambda: vilt_weights(SEQ_HEADS)[1]),
        "spmd": ({"fed": 16}, lambda: vilt_weights({"fed": 16})[1]),
        "albef": (None, lambda: albef_weights(SMALL)),
    }.items():
        params = make()
        bridge = param_bridge.albef_from_flax if name == "albef" else param_bridge.vilt_from_flax
        torch.save(bridge(params), root / f"{name}.pt")
        out[name] = (params, str(root / f"{name}.pt"), heads)
    return out


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    data_root, vocab = write_task(tmp_path_factory.mktemp("tp_cli"), key=TASK)
    spec = dict(task_key=TASK, task_name=TASK, data_dir=str(data_root / TASK),
                images_source="vizwiz", splits=("train_small", "val"), num_labels=100)
    return data_root, vocab, spec


def cli_argv(task, out, *extra):
    data_root, vocab, _ = task
    argv = smoke_argv(data_root, vocab, out, "--device", "cpu", *extra)
    argv[argv.index("--ordered_cl_tasks") + 1] = TASK
    argv[argv.index("--comm_rounds") + 1] = "1"
    return argv


@pytest.fixture(scope="module")
def tmp(tmp_path_factory):
    return tmp_path_factory.mktemp("tp_world")


@pytest.fixture(scope="module")
def started(weights, task, tmp):
    """The world of 4 ranks, started before the JAX references (every JAX
    fixture takes this one), which run while the ranks work."""
    seq_w, spmd_w, albef_w = weights["seq"][1], weights["spmd"][1], weights["albef"][1]
    batch = tiny_batch(np.random.RandomState(4), 4)
    batch["target_scores"] = np.random.RandomState(5).rand(4, 16).astype(np.float32)
    cases = [
        ("shards_vilt", "shards", dict(model_cfg=port_config(TINY_VILT),
                                        heads=port_heads(SEQ_HEADS), weights=seq_w)),
        ("shards_albef", "shards", dict(model_cfg=albef_port_config(SMALL), heads=None,
                                         weights=albef_w, family="albef")),
        ("forward_vilt", "forward", dict(family="vilt", model_cfg=port_config(TINY_VILT),
                                         heads=port_heads(SEQ_HEADS), weights=seq_w,
                                         batch=FORWARD_BATCH, task_key="cl_0")),
        ("forward_albef", "forward", dict(family="albef", model_cfg=albef_port_config(SMALL),
                                          heads=None, weights=albef_w, batch=albef_batch())),
        ("seq", "seq_round", dict(model_cfg=port_config(TINY_VILT), heads=port_heads(SEQ_HEADS),
                                  weights=seq_w, clients=vqa_clients(SEQ_HEADS), config=cfg(PORT),
                                  ckpt=str(tmp / "ckpt"))),
        ("albef", "albef_step", dict(model_cfg=albef_port_config(SMALL), weights=albef_w,
                                     client=ALBEF_CLIENT, opt=OptimizerConfig(lr=LR))),
        ("spmd", "spmd_round", dict(model_cfg=port_config(TINY_VILT), heads=port_heads({"fed": 16}),
                                    weights=spmd_w, clients=vqa_clients(["client_0", "client_1"]),
                                    config=cfg(PORT, num_epochs=2))),
        *[(f"mode_{m}", "modes", dict(model_cfg=port_config(c), heads=port_heads({"t": 16}),
                                       batch=batch, mode=m, lr=LR))
          for m, c in MODE_CFGS.items()],
        ("cli", "cli", dict(argv=cli_argv(task, tmp / "cli", "--tp", "2"), task=task[2])),
    ]
    world = start(4, tmp, cases)
    yield world
    world.close()


@pytest.fixture(scope="module")
def world4(started, jax_forward, jax_seq, jax_albef_loss, jax_spmd):
    return started.results


def _bridged(tree, family="vilt"):
    bridge = param_bridge.albef_from_flax if family == "albef" else param_bridge.vilt_from_flax
    return bridge(jax.tree_util.tree_map(np.asarray, tree))


def _assert_close(got, want, tol, what):
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=f"{what}: {k}",
                                   **tol)


# ------------------------------------------------------------------ (a), (b)

def _marked(params):
    """Each leaf filled with its JAX sharding: 0 replicated; for a sharded
    leaf ``1000·code + index`` along the sharded axis (code 1 column, 2 row)."""
    flat = traverse_util.flatten_dict(params)
    out = {}
    for path, leaf in flat.items():
        spec = tuple(jtp.tp_spec_for(path, leaf))
        shape = np.shape(leaf)
        arr = np.zeros(shape, np.float32)
        if jtp.MODEL_AXIS in spec:
            axis = spec.index(jtp.MODEL_AXIS)
            code = 1 if axis == len(shape) - 1 else 2
            idx = np.arange(shape[axis], dtype=np.float32).reshape(
                [-1 if i == axis else 1 for i in range(len(shape))])
            arr = arr + 1000.0 * code + idx
        out[path] = arr
    return traverse_util.unflatten_dict(out)


@pytest.mark.parametrize("family", ["vilt", "viltbert", "albef"])
def test_specs_shard_what_jax_shards_along_the_transposed_axis(family):
    if family == "vilt":
        params, bridge = vilt_weights(SEQ_HEADS)[1], param_bridge.vilt_from_flax
    elif family == "viltbert":
        params, bridge = viltbert_weights(TINY_VILT), param_bridge.viltbert_from_flax
    else:
        params, bridge = albef_weights(), param_bridge.albef_from_flax
    ported = bridge(_marked(params))
    counts = {0: 0, 1: 0, None: 0}
    for name, t in ported.items():
        dim = tp.tp_spec_for(name, t)
        counts[dim] += 1
        if dim is None:
            assert not t.any(), f"{name}: JAX shards it, the port does not"
            continue
        code = 1 if dim == 0 else 2
        idx = torch.arange(t.shape[dim], dtype=torch.float32)
        want = 1000.0 * code + idx.reshape([-1 if i == dim else 1 for i in range(t.dim())])
        assert torch.equal(t, want.expand_as(t)), f"{name}: dim {dim} is not JAX's sharded axis"
    # every layer's q, k, v, intermediate (column) and out, output (row),
    # and the cross-attention's q, k, v and out of ALBEF's fusion and decoder layers
    layers = {"vilt": 2, "viltbert": 2 + 2, "albef": 2 + 4 + 2}[family]
    crosses = {"vilt": 0, "viltbert": 0, "albef": 2 + 2}[family]
    assert counts[0] == 4 * layers + 3 * crosses
    assert counts[1] == 2 * layers + crosses


def test_shards_gather_back_bitwise(world4):
    for case in ("shards_vilt", "shards_albef"):
        for r in world4:
            got = r[case]
            assert got["bitwise"], case
            for name, (local, full) in got["shapes"].items():  # half of every sharded kernel
                dim = tp.tp_spec_for(name, torch.empty(full))
                want = tuple(n // 2 if i == dim else n for i, n in enumerate(full))
                assert local == want, name
            assert 2 * got["bytes"]["sharded"] == got["full_bytes"]["sharded"]
    shapes = world4[0]["shards_vilt"]["shapes"]
    assert shapes["vilt.layers.1.attention.query.dense.weight"][0] == (16, 32)
    assert shapes["vilt.layers.1.attention.query.dense.bias"][0] == (32,)
    assert shapes["vilt.layers.1.attention.out.weight"][0] == (32, 16)
    assert shapes["vilt.layers.1.mlp.intermediate.weight"][0] == (32, 32)
    assert shapes["vilt.layers.1.adapter.adapter_0_down.weight"][0] == (8, 32)


@pytest.fixture(scope="module")
def jax_forward(started, weights):
    """JAX's ``tp_forward`` on a (data=2, model=2) mesh: ViLT's logits and
    ALBEF's loss."""
    mesh = jtp.make_tp_mesh(2, 2, devices=jax.devices()[:4])
    model = JaxVilt(TINY_VILT, {k: JaxHeadSpec(num_labels=n) for k, n in SEQ_HEADS.items()})
    fn, place = jtp.tp_forward(model, mesh, task_key="cl_0")
    logits = np.asarray(fn(jtp.shard_params_tp(weights["seq"][0], mesh), place(FORWARD_BATCH)))
    fn, place = jtp.tp_forward(JaxAlbef(SMALL), mesh)
    loss = float(fn(jtp.shard_params_tp(weights["albef"][0], mesh), place(albef_batch())))
    return logits, loss


def test_tp_forward_matches_jax(world4, jax_forward):
    """JAX's tests/test_tp.py::test_tp_forward_matches_single_device and
    ::test_tp_forward_albef on the port: each data rank's logits are its
    rows of JAX's; the loss is the whole batch's on every rank."""
    logits, loss = jax_forward
    rows = logits.shape[0] // 2
    for r in world4:
        got = r["forward_vilt"]
        want = logits[got["data"] * rows:(got["data"] + 1) * rows]
        np.testing.assert_allclose(got["out"].numpy(), want, rtol=2e-5, atol=2e-6)
        np.testing.assert_allclose(float(r["forward_albef"]["out"]), loss, rtol=2e-5)


# ------------------------------------------------------------------ (c), (g)

@pytest.fixture(scope="module")
def jax_seq(started, weights):
    params = weights["seq"][0]
    model = JaxVilt(TINY_VILT, {k: JaxHeadSpec(num_labels=n) for k, n in SEQ_HEADS.items()})
    clients = {c["task_key"]: JaxClient(**c) for c in vqa_clients(SEQ_HEADS)}
    trainer = JaxTrainer(model, params, clients, cfg(JAX),
                         tp_mesh=jtp.make_tp_mesh(2, 2, devices=jax.devices()[:4]))
    trainer.run_round(0)
    return trainer


@pytest.fixture(scope="module")
def port_seq(weights):
    model = make_model("vilt", port_config(TINY_VILT), port_heads(SEQ_HEADS), weights["seq"][1])
    clients = {c["task_key"]: SyntheticVQAClient(**c) for c in vqa_clients(SEQ_HEADS)}
    trainer = FederatedTrainer(model, None, clients, cfg(PORT), device="cpu")
    return trainer, trainer.run(resume=False)


def test_sequential_round_matches_jax_tp_and_the_world_of_one(world4, jax_seq, port_seq):
    """The scores against the world of one (whose scores test_torch_federated.py
    holds against JAX's)."""
    jt = jax_seq
    seq = [r["seq"] for r in world4]
    for r in seq[1:]:  # every rank ends with the same whole parameters
        for k, v in seq[0]["server"].items():
            assert torch.equal(r["server"][k], v), k
    _assert_close(seq[0]["server"], _bridged(jt.server_params), JAX_TP, "vs JAX --tp")
    _assert_close(seq[0]["server"], port_seq[0].server_params, JAX_TP, "vs the world of one")
    for r in seq:
        assert len(r["history"]) == 1
        for key in SEQ_HEADS:
            np.testing.assert_allclose(r["history"][0]["scores"][key],
                                       port_seq[1][0]["scores"][key], rtol=2e-5, atol=1e-6)


def test_tp_checkpoint_restores_into_tp2_and_tp1(world4, weights, tmp):
    seq = [r["seq"] for r in world4]
    assert all(r["latest"] == 0 and r["resumed_at"] == 1 for r in seq)
    assert all(r["resumed_bitwise"] and r["personal_bitwise"] for r in seq)
    model = make_model("vilt", port_config(TINY_VILT), port_heads(SEQ_HEADS), weights["seq"][1])
    clients = {c["task_key"]: SyntheticVQAClient(**c) for c in vqa_clients(SEQ_HEADS)}
    one = FederatedTrainer(model, None, clients, cfg(PORT), device="cpu",
                           checkpoint_dir=str(tmp / "ckpt"))
    assert one.try_resume() == 1
    full = model.state_dict()
    for k, v in seq[0]["server"].items():  # JAX's full layout, restored whole into tp=1
        assert one.server_params[k].shape == full[k].shape
        assert torch.equal(one.server_params[k], v), k


# ------------------------------------------------------------------ (d)

@pytest.fixture(scope="module")
def jax_albef_loss(started, weights):
    from feddat_tpu.train.dat import Partitioner as JaxPartitioner
    from feddat_tpu.train.dat import init_train_state as jax_init_state
    from feddat_tpu.train.dat import make_dat_train_step as jax_dat_step
    from feddat_tpu.train.forwards import make_albef_forward as jax_albef_forward
    from jax.sharding import NamedSharding, PartitionSpec

    params = weights["albef"][0]
    model = JaxAlbef(SMALL)
    batch = next(JaxAlbefClient(**ALBEF_CLIENT).train_batches(0))
    part = JaxPartitioner(params, "c", JaxPEFTMode.DAT)
    opt = JaxOptimizerConfig(lr=LR)
    step = jax_dat_step(jax_albef_forward(model), part, opt, max_steps=10, donate=False)
    mesh = jtp.make_tp_mesh(2, 2, devices=jax.devices()[:4])
    state = jax_init_state(params, part, opt, jax.random.PRNGKey(3))
    state = state.replace(params=jtp.shard_params_tp(state.params, mesh))
    placed = {k: jax.device_put(v, NamedSharding(mesh, PartitionSpec("data")))
              for k, v in batch.items()}
    return float(step(state, placed)[1]["loss"])


def test_albef_dat_step_loss_matches_jax_tp(world4, jax_albef_loss):
    losses = [r["albef"]["loss"] for r in world4]
    assert len(set(losses)) == 1  # the data group's mean, on every rank
    np.testing.assert_allclose(losses[0], jax_albef_loss, rtol=2e-5)


# ------------------------------------------------------------------ (e)

@pytest.fixture(scope="module")
def jax_spmd(started, weights):
    from feddat_tpu.federated.spmd import FED_HEAD_KEY

    params = weights["spmd"][0]
    model = JaxVilt(TINY_VILT, {FED_HEAD_KEY: JaxHeadSpec(num_labels=16)})
    clients = [JaxClient(**c) for c in vqa_clients(["client_0", "client_1"])]
    mesh = jax_make_mesh(2, 1, devices=jax.devices()[:4], model_parallel=2)
    trainer = JaxSPMD(model, params, clients, cfg(JAX, num_epochs=2), mesh)
    trainer.run_round(0)
    return jax.tree_util.tree_map(np.asarray, trainer.client_state), trainer.evaluate_round(0)


def test_spmd_model_axis_round_matches_jax(world4, jax_spmd):
    state, scores = jax_spmd
    for r in world4:
        got = r["spmd"]
        want = _bridged(jax.tree_util.tree_map(lambda x: x[got["slot"]], state))
        _assert_close(got["state"], want, JAX_TP_SPMD, f"client {got['slot']}")
        assert got["scores"]["scores"].keys() == scores["scores"].keys()
        for k in scores["scores"]:  # once per client, not once per model rank
            np.testing.assert_allclose(got["scores"]["scores"][k], scores["scores"][k],
                                       rtol=2e-4, atol=2e-4)


# ------------------------------------------------------------------ (f)

@pytest.mark.parametrize("mode", list(MODE_CFGS))
def test_one_step_at_model_2_is_tp_1(world4, mode):
    for r in world4:
        got = r[f"mode_{mode}"]
        one, two = got["tp1"], got["tp2"]
        assert one["trainable"] == two["trainable"]
        np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-6)
        for k, g in one["grads"].items():
            np.testing.assert_allclose(two["grads"][k].numpy(), g.numpy(), rtol=1e-4,
                                       atol=1e-6 * float(g.abs().max()) + 1e-9, err_msg=k)
        _assert_close(two["params"], {k: v.numpy() for k, v in one["params"].items()}, ADAM,
                      f"{mode} params")
    # every replicated trainable is the same on the ranks of a model group
    for a, b in ((0, 1), (2, 3)):
        ra, rb = world4[a][f"mode_{mode}"]["replicated"], world4[b][f"mode_{mode}"]["replicated"]
        assert ra and ra.keys() == rb.keys()
        for k in ra:
            assert torch.equal(ra[k], rb[k]), k


# ------------------------------------------------------------------ (h)

GUARD_CASES = [
    ["--tp", "2", "--attn_impl", "block"],
    ["--tp", "2", "--attn_impl", "flash"],
    ["--tp", "2", "--attn_impl", "fused"],
    ["--tp", "2", "--attn_impl", "layer"],
    ["--tp", "2", "--attn_impl", "auto"],
    ["--tp", "2", "--multihost"],
    ["--tp", "2", "--engine", "spmd"],
    ["--tp", "1", "--attn_impl", "block"],
]


def _guarded(module, argv):
    args = module.build_parser().parse_args(
        ["--encoder_name", "vilt", "--optimizer_mode", "dat", "--ordered_cl_tasks", "domain",
         "--climb_data_dir", "/x", *argv])
    err = io.StringIO()
    try:
        with contextlib.redirect_stderr(err):
            module.apply_tp_arg_guards(args)
        exit_msg = None
    except SystemExit as e:
        exit_msg = str(e)
    return args.attn_impl, exit_msg, err.getvalue().replace("[feddat_tpu_torch]", "[feddat_tpu]")


@pytest.mark.parametrize("argv", GUARD_CASES, ids=[" ".join(a) for a in GUARD_CASES])
def test_cli_tp_guards_are_jaxs_word_for_word(argv):
    assert _guarded(tcli, argv) == _guarded(jcli, argv)


def test_cli_batch_and_mesh_errors_are_jaxs():
    """The batch check under --tp (JAX's cli.py:792-798, inline there) and the
    mesh error of a launch without enough ranks."""
    class Mesh:
        shape = {"data": 4, "model": 2}

    args = tcli.build_parser().parse_args(["--encoder_name", "vilt", "--tp", "2",
                                           "--batch_size", "6"])
    with pytest.raises(SystemExit) as got:
        tcli.check_tp_batch(args, Mesh())
    dp = 4
    assert str(got.value) == (
        f"--batch_size {6} is not divisible by the "
        f"TP mesh's data axis ({dp} = {dp * 2} devices / "
        f"--tp {2}); batches are sharded over that axis")
    for model, data, n in ((2, None, 1), (2, 4, 4), (3, None, 8)):
        with pytest.raises(ValueError) as want:
            jtp.make_tp_mesh(model, data, devices=jax.devices()[:n])
        with pytest.raises(ValueError) as got:
            tp.tp_grid(model, data, world_size=n)
        assert str(got.value) == str(want.value)
    for model, data, n in ((2, None, 8), (4, 2, 8), (2, 1, 2)):
        want = jtp.make_tp_mesh(model, data, devices=jax.devices()[:n]).devices
        np.testing.assert_array_equal(tp.tp_grid(model, data, world_size=n),
                                      np.vectorize(lambda d: d.id)(want))


def test_cli_tp_launch_on_four_ranks_matches_the_world_of_one(world4, task, tmp):
    assert tcli.main(cli_argv(task, tmp / "cli_one")) == 0
    import json

    (one,) = (tmp / "cli_one" / "logs").glob("*.history.json")
    want = json.loads(one.read_text())
    got = world4[0]["cli"]["history"]
    assert all(r["cli"]["history"] is None for r in world4[1:])  # one writer
    assert len(got) == len(want) == 1
    np.testing.assert_allclose(got[0]["scores"][TASK], want[0]["scores"][TASK], rtol=2e-5,
                               atol=1e-6)
