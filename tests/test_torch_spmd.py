"""The port's SPMD engine (``feddat_tpu_torch/federated/spmd.py``) on the CPU:
worlds of ranks spawned over gloo (``tests/torch_spmd_worker.py``), held
against the JAX package's ``SPMDFederatedTrainer`` on the conftest's CPU
devices and against the port's own sequential engine, on tiny ViLT (JAX's
initial weights through ``utils/param_bridge.py``) and tiny ALBEF.

* C=2, D=2, fused DAT on ``"layer"`` (the plain versions of #1/#4), one
  round and its evaluation, against JAX's engine on a (2, 2) mesh with
  ``"auto"``: each client's partitions at rtol=1e-4 and atol=lr/50 (Adam
  turns the summation-order noise of a near-zero gradient element into up
  to a step of size lr, ROADMAP Queue 3), the scores exactly (counts of
  argmax hits); both data ranks of a client hold the same state, bitwise;
  every rank holds the same history.
* C=2, D=1 against the sequential ``FederatedTrainer`` (a model with one
  head per client, each initialised as the shared head): standard DAT,
  ``freeze_bottom_k_layers``, heterogeneous client sizes truncated to the
  smaller (with unequal eval sizes: padding batches) and ``full_epochs``
  (each client on its own schedule horizon), and ALBEF's fused step with
  dropout live.  Bitwise: the same steps and generators, and a FedAvg sum
  of two terms, which gloo adds as the sequential engine does.
* C=1, D=2 against C=1, D=1 (a world of one here): the gradient mean of two
  half batches against one batch, at the tolerance above.
* Two ranks where only rank 1 gets SIGTERM: both stop after the same round
  with one checkpoint per round, and a relaunch resumes to the
  uninterrupted run's state and history, bitwise.
* A world of one here: the engine is the sequential engine, bitwise."""

import dataclasses
import itertools
import os

import jax
import numpy as np
import pytest
import torch

from feddat_tpu.configs.core import FederatedConfig as JaxFederatedConfig
from feddat_tpu.configs.core import OptimizerConfig as JaxOptimizerConfig
from feddat_tpu.configs.core import PEFTMode as JaxPEFTMode
from feddat_tpu.configs.core import TrainConfig as JaxTrainConfig
from feddat_tpu.data.synthetic import SyntheticVQAClient as JaxClient
from feddat_tpu.federated.spmd import SPMDFederatedTrainer as JaxSPMD
from feddat_tpu.parallel.mesh import make_mesh as jax_make_mesh
from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
from feddat_tpu_torch.data.synthetic import SyntheticAlbefClient, SyntheticVQAClient
from feddat_tpu_torch.federated.engine import FederatedTrainer
from feddat_tpu_torch.federated.spmd import FED_HEAD_KEY, SPMDFederatedTrainer
from feddat_tpu_torch.models.vilt import TaskHeadSpec, ViltContinualLearner
from feddat_tpu_torch.parallel.mesh import make_mesh, world
from feddat_tpu_torch.train import trainers
from feddat_tpu_torch.utils.checkpointing import latest_round
from feddat_tpu_torch.utils.param_bridge import albef_from_flax, vilt_from_flax

from conftest import TINY_VILT
from test_torch_albef import LA, LQ, TINY, weights  # noqa: F401  (weights: a fixture)
from test_torch_albef import port_config as albef_port_config
from test_torch_vilt import jax_model_and_params, port_config
from torch_spmd_worker import make_model, spawn

LR = 5e-3
HEADS = {FED_HEAD_KEY: dict(num_labels=16)}
VQA = dict(num_eval=8, num_labels=16, vocab_size=TINY_VILT.vocab_size,
           text_len=TINY_VILT.max_text_len, image_size=TINY_VILT.image_size)
LIVE = dataclasses.replace(TINY, bert=dataclasses.replace(TINY.bert, hidden_dropout=0.1,
                                                          attention_dropout=0.1))
ALBEF = dict(num_train=8, num_eval=4, num_answers=8, vocab_size=TINY.bert.vocab_size,
             question_len=LQ, answer_len=LA, max_answers_per_q=2, image_size=(32, 32),
             batch_size=4, val_batch_size=4)
CPU = torch.device("cpu")


def cfg(mode=PEFTMode.DAT, rounds=1, eval_every=1, warmup=0.1, num_epochs=2, **kw):
    return TrainConfig(peft_mode=mode, optimizer=OptimizerConfig(lr=LR, warmup_ratio=warmup),
                       federated=FederatedConfig(comm_rounds=rounds, local_epochs=1,
                                                 eval_every=eval_every),
                       num_epochs=num_epochs, seed=0, **kw)


def vqa(sizes, batch=4, evals=None):
    return [dict(task_key=f"client_{i}", seed=i, num_train=n, batch_size=batch, val_batch_size=batch,
                 **{**VQA, **({"num_eval": evals[i]} if evals else {})})
            for i, n in enumerate(sizes)]


class Truncated:
    """A client cut to its first ``steps`` batches per epoch (the SPMD
    engine's truncation, as the sequential engine sees it)."""

    def __init__(self, client, steps):
        self.client, self.steps_per_epoch = client, steps

    def __getattr__(self, name):
        return getattr(self.client, name)

    def train_batches(self, epoch=0):
        return itertools.islice(self.client.train_batches(epoch), self.steps_per_epoch)


@pytest.fixture(scope="module")
def vilt(tmp_path_factory):
    jmodel, params = jax_model_and_params(TINY_VILT, heads=HEADS)
    path = tmp_path_factory.mktemp("spmd_weights") / "vilt.pt"
    sd = vilt_from_flax(params)
    torch.save(sd, path)
    return jmodel, params, sd, str(path)


@pytest.fixture(scope="module")
def albef_weights(weights, tmp_path_factory):  # noqa: F811
    path = tmp_path_factory.mktemp("spmd_albef") / "albef.pt"
    torch.save(albef_from_flax(weights), path)
    return str(path)


def vilt_case(vilt, specs, config, mesh, attn_impl="auto", **kw):
    return dict(family="vilt", model_cfg=port_config(TINY_VILT),
                heads={k: TaskHeadSpec(**v) for k, v in HEADS.items()}, weights=vilt[3],
                clients=specs, config=config, mesh_shape=mesh, attn_impl=attn_impl, **kw)


@pytest.fixture(scope="module")
def world2(vilt, albef_weights, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_world2")
    ckpt, whole = str(tmp / "ckpt"), str(tmp / "whole")
    three = cfg(rounds=3, eval_every=3)
    cases = [
        ("std", vilt_case(vilt, vqa([8, 8]), cfg(), (2, 1))),
        ("freeze", vilt_case(vilt, vqa([8, 8]), cfg(PEFTMode.FREEZE_BOTTOM_K, layers_to_freeze=1),
                             (2, 1))),
        ("trunc", vilt_case(vilt, vqa([8, 16], evals=[4, 8]), cfg(num_epochs=1), (2, 1))),
        ("full", vilt_case(vilt, vqa([8, 16]), cfg(warmup=0.25, num_epochs=1), (2, 1),
                           full_epochs=True)),
        ("albef", dict(family="albef", model_cfg=albef_port_config(LIVE), heads=None,
                       weights=albef_weights,
                       clients=[dict(task_key=f"client_{i}", seed=i, **ALBEF) for i in range(2)],
                       config=cfg(), mesh_shape=(2, 1), attn_impl="flash", use_fused=True,
                       rank_k=4)),
        ("c1d2", vilt_case(vilt, vqa([16], batch=8), cfg(), (1, 2), "layer", use_fused=True)),
        ("preempt", vilt_case(vilt, vqa([8, 8]), three, (2, 1), checkpoint_dir=ckpt,
                              sigterm=(1, 1))),
        ("resume", vilt_case(vilt, vqa([8, 8]), three, (2, 1), checkpoint_dir=ckpt, resume=True)),
        ("whole", vilt_case(vilt, vqa([8, 8]), three, (2, 1), checkpoint_dir=whole)),
    ]
    return spawn(2, tmp, cases), ckpt


@pytest.fixture(scope="module")
def world4(vilt, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("spmd_world4")
    case = vilt_case(vilt, vqa([8, 8]), cfg(), (2, 2), "layer", use_fused=True)
    return spawn(4, tmp, [("c2d2", case)])


def sequential(model, clients, config, **kw):
    t = FederatedTrainer(model, None, {c.task_key: c for c in clients}, config, device="cpu", **kw)
    t.run()
    return t


def vilt_sequential(vilt, clients, config, attn_impl="auto", **kw):
    """The sequential engine on a model with one head per client, each
    initialised as the shared head."""
    heads = {c.task_key: TaskHeadSpec(**HEADS[FED_HEAD_KEY]) for c in clients}
    sd = {}
    for k, v in vilt[2].items():
        for c in clients if k.startswith(f"task_{FED_HEAD_KEY}.") else [None]:
            sd[k if c is None else k.replace(f"task_{FED_HEAD_KEY}.", f"task_{c.task_key}.")] = v
    model = ViltContinualLearner(port_config(TINY_VILT), heads, attn_impl=attn_impl)
    model.load_state_dict(sd, strict=True)
    return sequential(model.eval(), clients, config, **kw)


def assert_rank_is_sequential(r, seq):
    """A rank's parameters after the run (server view and client state) and
    history against the sequential engine's client of the same slot."""
    key = seq.clients[r["slot"]].task_key
    got = {k.replace(f"task_{FED_HEAD_KEY}.", f"task_{key}."): v
           for k, v in {**r["server"], **r["client_state"]}.items()}
    want = seq._client_params(seq.clients[r["slot"]], refresh=False)
    bad = [k for k, v in got.items() if not torch.equal(v, want[k])]
    assert not bad, bad[:5]
    # the sequential engine scores a single-mode run as a float, the SPMD
    # engine as a list of one, as JAX's two engines do
    assert r["history"] == [{**e, "scores": {k: v if isinstance(v, list) else [v]
                                             for k, v in e["scores"].items()}} for e in seq.history]


@pytest.mark.parametrize("case", ["std", "freeze"])
def test_c2_d1_matches_the_sequential_engine_bitwise(case, world2, vilt):
    ranks, _ = world2
    mode = PEFTMode.DAT if case == "std" else PEFTMode.FREEZE_BOTTOM_K
    config = cfg(mode, **({"layers_to_freeze": 1} if case == "freeze" else {}))
    seq = vilt_sequential(vilt, [SyntheticVQAClient(**s) for s in vqa([8, 8])], config)
    for r in ranks:
        assert_rank_is_sequential(r[case], seq)
    if case == "freeze":  # no communicated set: only the personal heads moved
        r = ranks[0][case]
        moved = [k for k, v in r["client_state"].items() if not torch.equal(v, vilt[2][k])]
        assert moved and all(k.startswith(f"task_{FED_HEAD_KEY}.") for k in moved)


def test_heterogeneous_sizes_truncate_to_the_smaller_client(world2, vilt):
    ranks, _ = world2
    clients = [SyntheticVQAClient(**s) for s in vqa([8, 16], evals=[4, 8])]
    seq = vilt_sequential(vilt, [Truncated(c, 2) for c in clients], cfg(num_epochs=1))
    for r in ranks:
        assert_rank_is_sequential(r["trunc"], seq)


def test_full_epochs_run_each_client_on_its_own_horizon(world2, vilt):
    ranks, _ = world2
    seq = vilt_sequential(vilt, [SyntheticVQAClient(**s) for s in vqa([8, 16])],
                          cfg(warmup=0.25, num_epochs=1))
    for r in ranks:
        assert_rank_is_sequential(r["full"], seq)


def test_albef_fused_round_with_dropout_matches_the_sequential_engine(world2, albef_weights):
    ranks, _ = world2
    clients = [SyntheticAlbefClient(task_key=f"client_{i}", seed=i, **ALBEF) for i in range(2)]
    hooks = trainers.resolve_trainer("albef_no_distill", "vqa", rank_k=4, answer_banks={
        c.task_key: (c.answer_ids, c.answer_mask) for c in clients})
    model = make_model("albef", albef_port_config(LIVE), None, albef_weights, "flash")
    seq = sequential(model, clients, cfg(), make_forward=hooks.make_forward,
                     make_eval=hooks.make_eval, use_fused_dat=True)
    for r in ranks:
        assert_rank_is_sequential(r["albef"], seq)
        assert len(r["albef"]["history"][0]["scores"]["client_0"]) == 3


def test_data_parallel_halves_match_one_rank(world2, vilt):
    """C=1, D=2 against C=1, D=1: both ranks bitwise alike, and against the
    world of one at rtol=1e-4, atol=lr/50; scores exactly."""
    ranks, _ = world2
    with world(CPU):
        mesh = make_mesh(1, device_type="cpu")
        model = make_model("vilt", port_config(TINY_VILT), {FED_HEAD_KEY: TaskHeadSpec(16)},
                           vilt[3], "layer")
        one = SPMDFederatedTrainer(model, None, [SyntheticVQAClient(**vqa([16], batch=8)[0])],
                                   cfg(), mesh, use_fused=True, device="cpu")
        one.run()
    a, b = ranks[0]["c1d2"], ranks[1]["c1d2"]
    assert (a["data"], b["data"]) == (0, 1)
    for k, v in a["client_state"].items():
        assert torch.equal(v, b["client_state"][k]), k
        np.testing.assert_allclose(v.numpy(), one.client_state[k].numpy(), rtol=1e-4, atol=LR / 50,
                                   err_msg=k)
    assert a["history"] == b["history"]
    np.testing.assert_allclose(a["history"][0]["scores"]["client_0"],
                               one.history[0]["scores"]["client_0"], rtol=0, atol=1e-9)


def test_sigterm_on_one_rank_stops_every_rank_at_the_same_round(world2):
    ranks, ckpt = world2
    assert [r["preempt"]["history"] for r in ranks] == [[], []]
    assert [r["preempt"]["latest"] for r in ranks] == [1, 1]
    assert latest_round(ckpt) == 2  # rounds 0 and 1 of the cut run, round 2 of the relaunch
    assert sorted(os.listdir(ckpt)) == ["round_00000", "round_00001", "round_00002"]
    cut = torch.load(os.path.join(ckpt, "round_00001"), weights_only=True)
    assert set(cut["personal"]) == {"stacked_clients"}
    assert all(v.shape[0] == 2 for v in cut["personal"]["stacked_clients"].values())


def test_the_relaunch_resumes_to_the_uninterrupted_run_bitwise(world2):
    ranks, _ = world2
    for r in ranks:
        got, want = r["resume"], r["whole"]
        assert got["history"] == want["history"] and [e["round"] for e in got["history"]] == [2]
        for k, v in want["client_state"].items():
            assert torch.equal(got["client_state"][k], v), k
    # the relaunch and the uninterrupted run differ from the cut run's last state
    assert not all(torch.equal(ranks[0]["preempt"]["client_state"][k], v)
                   for k, v in ranks[0]["whole"]["client_state"].items())


@pytest.fixture(scope="module")
def jax_c2d2(vilt):
    jmodel, params, _, _ = vilt
    jcfg = JaxTrainConfig(peft_mode=JaxPEFTMode.DAT,
                          optimizer=JaxOptimizerConfig(lr=LR, warmup_ratio=0.1),
                          federated=JaxFederatedConfig(comm_rounds=1, local_epochs=1, eval_every=1),
                          num_epochs=2, seed=0)
    clients = [JaxClient(**s) for s in vqa([8, 8])]
    jt = JaxSPMD(jmodel, params, clients, jcfg, jax_make_mesh(num_clients=2, data_parallel=2),
                 use_fused=True)
    jt.run(resume=False)
    return jt


def test_c2_d2_fused_round_matches_jax(world4, jax_c2d2):
    stacked = jax.tree_util.tree_map(np.asarray, jax_c2d2.client_state)
    for r in world4:
        part = vilt_from_flax(jax.tree_util.tree_map(lambda x: x[r["c2d2"]["slot"]], stacked))
        got = {k: v for k, v in r["c2d2"]["client_state"].items()}
        assert set(got) == set(part)
        for k, v in part.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=1e-4, atol=LR / 50, err_msg=k)
    moved = [k for k, v in world4[0]["c2d2"]["client_state"].items()
             if "adapter_1" in k and not torch.equal(v, world4[2]["c2d2"]["client_state"][k])]
    assert not moved  # FedAvg: both clients hold the same communicated partition


def test_c2_d2_data_ranks_agree_and_every_rank_holds_the_history(world4, jax_c2d2):
    by_slot = {}
    for r in world4:
        by_slot.setdefault(r["c2d2"]["slot"], []).append(r["c2d2"])
    assert sorted(by_slot) == [0, 1] and all(len(v) == 2 for v in by_slot.values())
    for a, b in by_slot.values():
        assert {a["data"], b["data"]} == {0, 1}
        assert all(torch.equal(v, b["client_state"][k]) for k, v in a["client_state"].items())
    histories = [r["c2d2"]["history"] for r in world4]
    assert all(h == histories[0] for h in histories)
    (je,), (te,) = jax_c2d2.history, histories[0]
    assert te["round"] == je["round"] == 0
    for key in ("client_0", "client_1"):
        np.testing.assert_allclose(te["scores"][key], je["scores"][key], rtol=0, atol=1e-9)


def test_a_world_of_one_is_the_sequential_engine_bitwise(vilt, tmp_path):
    """One client "fed" on the card's configuration (fused DAT, "layer"):
    server parameters, personal store and scores over 2 rounds, and the
    checkpoint in JAX's layout, which serving reads."""
    config = cfg(rounds=2)
    spec = dict(vqa([8])[0], task_key=FED_HEAD_KEY)
    heads = {FED_HEAD_KEY: TaskHeadSpec(16)}
    seq = FederatedTrainer(make_model("vilt", port_config(TINY_VILT), heads, vilt[3], "layer"), None,
                           {FED_HEAD_KEY: SyntheticVQAClient(**spec)}, config, use_fused_dat=True,
                           device="cpu")
    seq.run()
    with world(CPU) as size:
        assert size == 1
        eng = SPMDFederatedTrainer(make_model("vilt", port_config(TINY_VILT), heads, vilt[3], "layer"),
                                   None, [SyntheticVQAClient(**spec)], config, make_mesh(1, device_type="cpu"),
                                   use_fused=True, checkpoint_dir=str(tmp_path), device="cpu")
        eng.run()
    assert eng.history == seq.history
    assert all(torch.equal(v, eng.server_params[k]) for k, v in seq.server_params.items())
    personal = eng.personal()
    assert set(personal) == set(seq.personal[FED_HEAD_KEY])
    assert all(torch.equal(v, personal[k]) for k, v in seq.personal[FED_HEAD_KEY].items())
    saved = torch.load(tmp_path / "round_00001", weights_only=True)
    assert set(saved["server_params"]) == set(eng.backbone)
    assert all(torch.equal(v[0], eng.client_state[k])
               for k, v in saved["personal"]["stacked_clients"].items())
