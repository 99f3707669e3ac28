"""The port's checkpoints, resume, preemption and serving from a checkpoint
(``utils/checkpointing.py``, ``utils/preemption.py``, the engine's
``save_checkpoint``/``try_resume``/``run``, ``serving.*.from_checkpoint``) on
the CPU at tiny widths, in float32.

Within the port everything is bitwise: a save and restore round-trips every
tensor and the generator's state; a run cut after round 1 (by a call, or by a
SIGTERM raised inside round 1) and resumed by a fresh trainer ends with the
uninterrupted run's server and personal parameters and last evaluation; a
predictor served from the checkpoint holds the trainer's own personalised
parameters.  Against the JAX package: the resumed run's parameters at
tests/test_torch_federated.py's tolerances (rtol=1e-4, atol=lr/50), both
predictors' ``from_checkpoint`` on one trained state at
tests/test_torch_serving.py's and tests/test_torch_albef.py's (rtol=1e-4,
atol=1e-5, answers equal), and ``meta.json`` byte for byte."""

import dataclasses
import itertools
import os
import signal

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from feddat_tpu.configs.core import FederatedConfig as JaxFederatedConfig
from feddat_tpu.configs.core import OptimizerConfig as JaxOptimizerConfig
from feddat_tpu.configs.core import PEFTMode as JaxPEFTMode
from feddat_tpu.configs.core import TrainConfig as JaxTrainConfig
from feddat_tpu.data.synthetic import SyntheticVQAClient as JaxClient
from feddat_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from feddat_tpu.federated.engine import FederatedTrainer as JaxTrainer
from feddat_tpu.models.albef import AlbefModel as JaxAlbef
from feddat_tpu.models.vilt import TaskHeadSpec as JaxHeadSpec
from feddat_tpu.peft.partition import label_params as jax_label_params
from feddat_tpu.peft.partition import personal_roles as jax_personal_roles
from feddat_tpu.peft.partition import split_by_roles as jax_split_by_roles
from feddat_tpu.serving import AlbefVqaPredictor as JaxAlbefPredictor
from feddat_tpu.serving import ViltVqaPredictor as JaxViltPredictor
from feddat_tpu.utils import checkpointing as jax_ckpt
from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
from feddat_tpu_torch.data.synthetic import SyntheticVQAClient
from feddat_tpu_torch.data.tokenizer import WordPieceTokenizer
from feddat_tpu_torch.federated.engine import FederatedTrainer
from feddat_tpu_torch.serving import AlbefVqaPredictor, ViltVqaPredictor, _load_checkpoint_recipe
from feddat_tpu_torch.utils import checkpointing as ckpt
from feddat_tpu_torch.utils.param_bridge import albef_from_flax, vilt_from_flax
from feddat_tpu_torch.utils.preemption import GracefulPreemption

from conftest import TINY_VILT
from test_torch_albef import ANSWERS, LA, LQ, QUESTIONS, TINY, WORDS, port_model as albef_port_model
from test_torch_albef import weights as albef_weights  # noqa: F401  (a fixture)
from test_torch_federated import CLIENT, HEADS, OPT
from test_torch_vilt import jax_model_and_params, port_model

ROUNDS = 3
STEPS_PER_ROUND = len(HEADS) * CLIENT["num_train"] // CLIENT["batch_size"]
CPU = torch.device("cpu")


def _cfg(mod, rounds=ROUNDS):
    return mod["TrainConfig"](
        peft_mode=mod["PEFTMode"].DAT, optimizer=mod["OptimizerConfig"](**OPT),
        federated=mod["FederatedConfig"](comm_rounds=rounds, local_epochs=1, eval_every=1),
        num_epochs=2, seed=0)


PORT = dict(TrainConfig=TrainConfig, PEFTMode=PEFTMode, OptimizerConfig=OptimizerConfig,
            FederatedConfig=FederatedConfig)
JAX = dict(TrainConfig=JaxTrainConfig, PEFTMode=JaxPEFTMode, OptimizerConfig=JaxOptimizerConfig,
           FederatedConfig=JaxFederatedConfig)


@pytest.fixture(scope="module")
def weights():
    return jax_model_and_params(TINY_VILT, heads=HEADS)


def _trainer(params, directory, batch_transform=None, rounds=ROUNDS):
    model = port_model(TINY_VILT, params, "layer", HEADS)
    clients = {k: SyntheticVQAClient(k, seed=i, **CLIENT) for i, k in enumerate(HEADS)}
    return FederatedTrainer(model, None, clients, _cfg(PORT, rounds), use_fused_dat=True,
                            checkpoint_dir=None if directory is None else str(directory),
                            batch_transform=batch_transform, device="cpu")


def _assert_same(got, want, what):
    assert set(got) == set(want), what
    for k in want:
        if isinstance(want[k], dict):
            _assert_same(got[k], want[k], f"{what}/{k}")
        else:
            assert torch.equal(got[k], want[k]), f"{what}: {k}"


def _assert_same_state(got, want):
    _assert_same(got.server_params, want.server_params, "server")
    _assert_same(got.personal, want.personal, "personal")


@pytest.fixture(scope="module")
def uninterrupted(weights, tmp_path_factory):
    """Run A: 3 rounds with a checkpoint per round, never interrupted."""
    directory = tmp_path_factory.mktemp("uninterrupted")
    trainer = _trainer(weights[1], directory)
    trainer.run()
    return trainer, directory


def test_save_restore_roundtrip(tmp_path):
    g = torch.Generator().manual_seed(7)
    torch.randint(0, 10, (5,), generator=g)
    server = {"layer.weight": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    shared = torch.ones(3)
    # a personal tensor aliasing the server's (the engine's starting store)
    personal = {"c0": {"head.bias": shared, "layer.weight": server["layer.weight"]},
                "c1": {"head.bias": shared[:2]}}
    path = ckpt.save_federated_state(str(tmp_path), 3, server, personal, g)
    assert path == os.path.join(str(tmp_path), "round_00003") and os.path.isfile(path)
    assert ckpt.latest_round(str(tmp_path)) == 3
    rnd, s2, p2, g2 = ckpt.restore_federated_state(str(tmp_path), device="cpu")
    assert rnd == 3
    _assert_same(s2, server, "server")
    _assert_same(p2, personal, "personal")
    assert p2["c1"]["head.bias"].untyped_storage().nbytes() == 2 * 4  # its own storage
    assert p2["c0"]["layer.weight"].data_ptr() != s2["layer.weight"].data_ptr()
    assert torch.equal(g2.get_state(), g.get_state())
    assert torch.equal(torch.randint(0, 10 ** 6, (8,), generator=g2),
                       torch.randint(0, 10 ** 6, (8,), generator=g))
    assert ckpt.restore_federated_state(str(tmp_path / "none"), device="cpu") is None


def test_latest_round_matches_round_names_strictly(tmp_path):
    g = torch.Generator().manual_seed(0)
    for r in (0, 2, 5):
        ckpt.save_federated_state(str(tmp_path), r, {"a": torch.full((1,), float(r))}, {}, g)
    os.makedirs(tmp_path / "round_00012_old")
    (tmp_path / "round_00009.tmp.123").write_bytes(b"a save cut short")
    (tmp_path / "round_7").write_bytes(b"")
    assert ckpt.latest_round(str(tmp_path)) == 5
    rnd, server, _, _ = ckpt.restore_federated_state(str(tmp_path), device="cpu")
    assert rnd == 5 and server["a"].item() == 5.0
    assert ckpt.restore_federated_state(str(tmp_path), 2, device="cpu")[1]["a"].item() == 2.0
    assert ckpt.latest_round(str(tmp_path / "missing")) is None
    assert [n for n in os.listdir(tmp_path) if ".tmp." in n] == ["round_00009.tmp.123"]


def test_meta_json_is_byte_equal_to_jax(tmp_path):
    meta = {"encoder_name": "vilt", "optimizer_mode": "dat", "adapter_reduction_factor": 16,
            "dtype": "bfloat16", "engine": "sequential", "tasks": ["vizwiz", "gqa"],
            "smoke": False, "image_size": [384, 640], "attention_logits_dtype": "float32",
            "heads": {"vizwiz": dataclasses.asdict(JaxHeadSpec(num_labels=100)),
                      "gqa": dataclasses.asdict(JaxHeadSpec(num_labels=100))}}
    a = jax_ckpt.write_meta(str(tmp_path / "jax"), meta)
    b = ckpt.write_meta(str(tmp_path / "port"), meta)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert ckpt.load_meta(str(tmp_path / "jax")) == meta
    assert ckpt.load_meta(str(tmp_path / "none")) is None


def test_resume_after_round_1_is_bitwise_the_uninterrupted_run(weights, uninterrupted, tmp_path):
    full, _ = uninterrupted
    first = _trainer(weights[1], tmp_path)
    first.run_round(0)
    first.run_round(1)
    first.save_checkpoint(1)
    fresh = _trainer(weights[1], tmp_path)
    assert fresh.try_resume() == 2
    _assert_same_state(fresh, first)
    assert torch.equal(fresh.rng.get_state(), first.rng.get_state())
    fresh.run_round(2)
    _assert_same_state(fresh, full)


def _sigterm_in_round(cut_round):
    """A batch_transform that raises SIGTERM at the first step of
    ``cut_round``, after checking that the engine's latch holds SIGTERM (a
    SIGTERM without it would end the process)."""
    calls = itertools.count()

    def transform(batch, epoch, step, steps_per_epoch):
        if next(calls) == cut_round * STEPS_PER_ROUND:
            handler = signal.getsignal(signal.SIGTERM)
            assert isinstance(getattr(handler, "__self__", None), GracefulPreemption), handler
            signal.raise_signal(signal.SIGTERM)
        return batch

    return transform


def test_sigterm_in_round_1_checkpoints_and_the_relaunch_finishes_bitwise(weights, uninterrupted,
                                                                          tmp_path):
    full, _ = uninterrupted
    before = signal.getsignal(signal.SIGTERM)
    cut = _trainer(weights[1], tmp_path, batch_transform=_sigterm_in_round(1))
    history = cut.run()
    assert signal.getsignal(signal.SIGTERM) is before
    assert ckpt.latest_round(str(tmp_path)) == 1
    # round 1 was finished, checkpointed and evaluated; no final evaluation
    assert [e["round"] for e in history] == [0, 1]
    assert history == full.history[:2]
    relaunch = _trainer(weights[1], tmp_path)
    history = relaunch.run()
    assert [e["round"] for e in history] == [ROUNDS - 1]
    assert history[-1] == full.history[-1]
    _assert_same_state(relaunch, full)
    assert ckpt.latest_round(str(tmp_path)) == ROUNDS - 1


def test_resume_at_the_last_round_still_evaluates(weights, uninterrupted):
    full, directory = uninterrupted
    again = _trainer(weights[1], directory)
    history = again.run()
    assert history == [full.history[-1]]
    _assert_same_state(again, full)
    assert _trainer(weights[1], directory).run(resume=False)[-1] == full.history[-1]


def _close(got, want_tree, what):
    want = vilt_from_flax(jax.tree_util.tree_map(np.asarray, want_tree))
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4,
                                   atol=OPT["lr"] / 50, err_msg=f"{what}: {k}")


@pytest.fixture(scope="module")
def jax_resumed(weights, tmp_path_factory):
    """JAX's engine: round 0, a checkpoint, the state restored from it and
    round 1 (tests/test_checkpoint.py:41-76; one trainer, so its steps
    compile once)."""
    jmodel, params = weights
    clients = {k: JaxClient(k, seed=i, **CLIENT) for i, k in enumerate(HEADS)}
    resumed = JaxTrainer(jmodel, params, clients, _cfg(JAX, 2), use_fused_dat=True,
                         checkpoint_dir=str(tmp_path_factory.mktemp("jax_resumed")))
    resumed.run_round(0)
    resumed.save_checkpoint(0)
    assert resumed.try_resume() == 1
    resumed.run_round(1)
    return resumed


def test_resumed_run_matches_jax(weights, jax_resumed, tmp_path):
    first = _trainer(weights[1], tmp_path, rounds=2)
    first.run_round(0)
    first.save_checkpoint(0)
    resumed = _trainer(weights[1], tmp_path, rounds=2)
    assert resumed.try_resume() == 1
    resumed.run_round(1)
    _close(resumed.server_params, jax_resumed.server_params, "server")
    for key in HEADS:
        _close(resumed.personal[key], jax_resumed.personal[key], f"{key} personal")


VILT_WORDS = ["what", "is", "the", "color"]
VILT_LABELS = [f"ans{i}" for i in range(16)]


def _vilt_meta(engine="sequential", tasks=tuple(HEADS), mode="dat", smoke=False):
    return {"encoder_name": "vilt", "optimizer_mode": mode, "adapter_reduction_factor": 4,
            "dtype": "float32", "engine": engine, "tasks": list(tasks), "smoke": smoke,
            "image_size": list(TINY_VILT.image_size), "attention_logits_dtype": "float32",
            "heads": {k: dataclasses.asdict(JaxHeadSpec(**HEADS[k])) if k in HEADS
                      else {"num_labels": 16} for k in tasks}}


def _images(n, seed, sizes=((40, 56), (33, 30), (64, 48))):
    rng = np.random.RandomState(seed)
    return [Image.fromarray(rng.randint(0, 255, (*sizes[i % len(sizes)], 3), dtype=np.uint8))
            for i in range(n)]


def test_vilt_from_checkpoint_serves_the_trainers_client_params(weights, uninterrupted):
    full, directory = uninterrupted
    ckpt.write_meta(str(directory), _vilt_meta())
    imgs, qs = _images(5, 3), [f"what is the color {i}" for i in range(5)]
    for i, key in enumerate(HEADS):
        client = full.clients[i]
        served = ViltVqaPredictor.from_checkpoint(
            str(directory), WordPieceTokenizer.toy(VILT_WORDS), VILT_LABELS, task_key=key,
            model=port_model(TINY_VILT, weights[1], "layer", HEADS), batch_size=4,
            canvas=TINY_VILT.image_size, max_text_len=TINY_VILT.max_text_len, device="cpu")
        assert served.adapter_mode == "ensemble" and served.task_key == key
        want = full._client_params(client, refresh=False)
        got = served.model.state_dict()
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
        direct = ViltVqaPredictor(port_model(TINY_VILT, weights[1], "layer", HEADS), want, key,
                                  WordPieceTokenizer.toy(VILT_WORDS), VILT_LABELS, batch_size=4,
                                  canvas=TINY_VILT.image_size, max_text_len=TINY_VILT.max_text_len,
                                  device="cpu")
        assert served.predict(imgs, qs, top_k=3) == direct.predict(imgs, qs, top_k=3)


def test_vilt_from_checkpoint_matches_jax(weights, jax_resumed, tmp_path):
    """One trained state (JAX's resumed run) in both packages' checkpoint
    formats: the two predictors agree."""
    jmodel, params = weights
    key = "c1"
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_resumed.checkpoint_dir = jdir
    jax_resumed.save_checkpoint(1)
    jax_ckpt.write_meta(jdir, _vilt_meta())
    ckpt.save_federated_state(
        pdir, 1, vilt_from_flax(jax.tree_util.tree_map(np.asarray, jax_resumed.server_params)),
        {k: vilt_from_flax(jax.tree_util.tree_map(np.asarray, v))
         for k, v in jax_resumed.personal.items()}, torch.Generator())
    ckpt.write_meta(pdir, _vilt_meta())
    common = dict(batch_size=4, canvas=TINY_VILT.image_size, max_text_len=TINY_VILT.max_text_len)
    want_pred = JaxViltPredictor.from_checkpoint(jdir, JaxTokenizer.toy(VILT_WORDS), VILT_LABELS,
                                                 task_key=key, model=jmodel, **common)
    got_pred = ViltVqaPredictor.from_checkpoint(pdir, WordPieceTokenizer.toy(VILT_WORDS), VILT_LABELS,
                                                task_key=key, model=port_model(TINY_VILT, params,
                                                                               "auto", HEADS),
                                                device="cpu", **common)
    assert got_pred.adapter_mode == want_pred.adapter_mode == "ensemble"
    imgs, qs = _images(5, 4), [f"what is the color {i}" for i in range(5)]
    want, got = want_pred.predict(imgs, qs, top_k=3), got_pred.predict(imgs, qs, top_k=3)
    for rg, rw in zip(got, want):
        assert [a for a, _ in rg] == [a for a, _ in rw]
        np.testing.assert_allclose([p for _, p in rg], [p for _, p in rw], rtol=1e-4, atol=1e-5)


def test_albef_from_checkpoint_matches_jax_with_the_recipes_answers(albef_weights, tmp_path):  # noqa: F811
    """tests/test_serving.py's ALBEF round trip in both packages: the
    sequential layout, the recipe's answer list, DAT's 'ensemble'."""
    labels = jax_label_params(albef_weights)
    personal, rest = jax_split_by_roles(albef_weights, labels, jax_personal_roles(JaxPEFTMode.DAT))
    meta = {"encoder_name": "albef_no_distill", "optimizer_mode": "dat",
            "adapter_reduction_factor": 4, "dtype": "float32", "engine": "sequential",
            "tasks": ["vqa_task"], "smoke": False, "image_size": None,
            "attention_logits_dtype": "float32", "heads": {"vqa_task": {"num_labels": 100}},
            "answer_lists": {"vqa_task": ANSWERS}}
    jdir, pdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_ckpt.save_federated_state(jdir, 0, rest, {"vqa_task": personal},
                                  jax.numpy.zeros((2,), jax.numpy.uint32))
    jax_ckpt.write_meta(jdir, meta)
    ckpt.save_federated_state(pdir, 0, albef_from_flax(rest),
                              {"vqa_task": albef_from_flax(personal)}, torch.Generator())
    ckpt.write_meta(pdir, meta)
    common = dict(batch_size=4, k=8, max_question_len=LQ, max_answer_len=LA)
    want_pred = JaxAlbefPredictor.from_checkpoint(jdir, JaxTokenizer.toy(WORDS), model=JaxAlbef(TINY),
                                                  **common)
    got_pred = AlbefVqaPredictor.from_checkpoint(pdir, WordPieceTokenizer.toy(WORDS),
                                                 model=albef_port_model(albef_weights), device="cpu",
                                                 **common)
    assert got_pred.answer_list == want_pred.answer_list == ANSWERS
    assert got_pred.adapter_mode == "ensemble"
    imgs = _images(5, 5)
    want, got = want_pred.predict(imgs, QUESTIONS, top_k=3), got_pred.predict(imgs, QUESTIONS, top_k=3)
    for rg, rw in zip(got, want):
        assert [a for a, _ in rg] == [a for a, _ in rw]
        np.testing.assert_allclose([p for _, p in rg], [p for _, p in rw], rtol=1e-4, atol=1e-5)
    direct = AlbefVqaPredictor(albef_port_model(albef_weights), albef_from_flax(albef_weights),
                               WordPieceTokenizer.toy(WORDS), ANSWERS, device="cpu", **common)
    assert direct.predict(imgs, QUESTIONS, top_k=3) == got
    with pytest.raises(ValueError, match="no answer list"):
        meta.pop("answer_lists")
        ckpt.write_meta(pdir, meta)
        AlbefVqaPredictor.from_checkpoint(pdir, WordPieceTokenizer.toy(WORDS),
                                          model=albef_port_model(albef_weights), device="cpu")


def test_recipe_rows_refusals_and_task_key_errors(tmp_path):
    """The SPMD layout's stacked row, the ``smoke`` refusal and JAX's
    task_key errors (serving.py:28-67)."""
    backbone = {"enc.w": torch.ones(2, 2)}
    stacked = {"task_fed.k": torch.stack([torch.full((3,), float(i)) for i in range(2)])}
    ckpt.save_federated_state(str(tmp_path), 0, backbone, {"stacked_clients": stacked},
                              torch.Generator())
    meta = _vilt_meta(engine="spmd", tasks=("a", "b"), mode="adapter")
    ckpt.write_meta(str(tmp_path), meta)
    got_meta, key, params, mode = _load_checkpoint_recipe(str(tmp_path), "b", CPU)
    assert (got_meta, key, mode) == (meta, "b", "adapter")
    assert torch.equal(params["task_fed.k"], torch.full((3,), 1.0))
    assert torch.equal(params["enc.w"], torch.ones(2, 2))
    with pytest.raises(KeyError, match="not in checkpoint tasks"):
        _load_checkpoint_recipe(str(tmp_path), "zzz", CPU)
    with pytest.raises(ValueError, match="pass task_key="):
        _load_checkpoint_recipe(str(tmp_path), None, CPU)
    ckpt.write_meta(str(tmp_path), dict(meta, tasks=["a"]))
    assert _load_checkpoint_recipe(str(tmp_path), None, CPU)[1] == "a"
    ckpt.write_meta(str(tmp_path), dict(meta, smoke=True))
    with pytest.raises(ValueError, match="smoke"):
        _load_checkpoint_recipe(str(tmp_path), "a", CPU)
    with pytest.raises(FileNotFoundError, match="no meta.json"):
        _load_checkpoint_recipe(str(tmp_path / "none"), "a", CPU)
    empty = tmp_path / "no_rounds"
    ckpt.write_meta(str(empty), meta)
    with pytest.raises(FileNotFoundError, match="no round checkpoints"):
        _load_checkpoint_recipe(str(empty), "a", CPU)
    for mode, want in (("dat", "ensemble"), ("adapter", "adapter"), ("lora", "none")):
        ckpt.write_meta(str(tmp_path), dict(meta, optimizer_mode=mode))
        assert _load_checkpoint_recipe(str(tmp_path), "a", CPU)[3] == want


def test_model_from_meta_rebuilds_the_recipes_model():
    """``_model_from_meta`` (serving.py:70-101) at the recipe's full width:
    the SPMD engine's one shared head, the canvas, the PEFT mode and
    ``create_model``'s default route."""
    from feddat_tpu_torch.serving import FED_HEAD_KEY, _model_from_meta

    meta = dict(_vilt_meta(engine="spmd", tasks=("a", "b")), image_size=[384, 640],
                adapter_reduction_factor=16, dtype="bfloat16", attention_logits_dtype=None)
    model, cfg = _model_from_meta(meta, CPU)
    heads = {k.split(".")[0] for k in model.state_dict() if k.startswith("task_")}
    assert heads == {f"task_{FED_HEAD_KEY}"} and FED_HEAD_KEY == "fed"
    assert cfg.image_size == (384, 640) and cfg.attention_logits_dtype == "float32"
    assert cfg.adapter.names == ("adapter_0", "adapter_1", "adapter_2")
    assert cfg.adapter.reduction_factor == 16 and model.attn_impl == "auto"
    assert next(model.parameters()).device == CPU
