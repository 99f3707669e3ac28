"""The port's CLI (``feddat_tpu_torch/cli.py``) against the JAX package's on
the CPU, on a task written to disk here (tests/test_cli_e2e.py's layout).

Both CLIs run the same ``--smoke --use_fused_dat --dtype float32`` ViLT DAT
command for 2 rounds with a checkpoint per round; the port's ``init_params``
is replaced by JAX's initial parameters carried over with
``utils/param_bridge.py``.  They agree on the run name, ``meta.json`` byte for
byte, the ``step`` records' losses (rtol 1e-4), the history's scores (atol
1e-9: counts of argmax hits) and the last round's server parameters (rtol
1e-4, atol lr/50, the tolerance of tests/test_torch_federated.py and its
reason).  The same, less the parameters, for ``--encoder_name viltbert`` on
that task (JAX's initial weights through ``viltbert_from_flax``) and for the
mixed set ``--ordered_cl_tasks nlvr2,snli-ve,vcr,vqa`` on a dataset written
by ``chip_smoke.py::write_classification_dataset`` (the standard DAT step,
each task's optimizer; the multiple-choice head's dropout off on both
sides), with ``meta.json`` byte for byte.  Also: the launch scripts' flags parse through the port's parser,
which has every flag of JAX's; each refusal exits before a model is built;
``--do_single``; a relaunch resumes; ``--pretrained_model_name`` gives the
backbone that the JAX CLI's conversion gives.  ``--engine spmd`` in a world
of one (gloo, in this process) against the JAX CLI's ``--engine spmd
--mesh_data 1`` on one device: the step losses (rtol 1e-4), the scores
(atol 1e-9) and the checkpoint's stacked client bank (rtol 1e-4, atol
lr/50); a mesh larger than the world raises JAX's error, ``--multihost``
without a rendezvous and the engine's other guards stop before any model."""

import json
import os
import pathlib
import pickle
import re
import shlex

import jax
import numpy as np
import pytest
import torch
from PIL import Image

import torch.distributed as dist

import feddat_tpu.cli as jcli
import feddat_tpu_torch.cli as tcli
from feddat_tpu.configs.tasks import TaskSpec as JaxTaskSpec
from feddat_tpu.configs.tasks import register_task as jax_register_task
from feddat_tpu_torch.configs.tasks import TaskSpec, register_task
from feddat_tpu_torch.utils.param_bridge import vilt_from_flax, viltbert_from_flax

from test_torch_checkpoint_convert import _hf_vilt_state_dict
from test_torch_classification_engine import COUNTS as CLS_COUNTS
from test_torch_classification_engine import SIZES as CLS_SIZES
from test_torch_classification_engine import chip_smoke, head_dropout_off

ROOT = pathlib.Path(__file__).resolve().parent.parent
TASK = "torch_cli_task"
LR = 5e-3
ROUNDS = 2


def register(key, data_dir):
    kw = dict(task_key=key, task_name=key, data_dir=str(data_dir), images_source="vizwiz",
              splits=("train_small", "val"), num_labels=100)
    jax_register_task(JaxTaskSpec(**kw), overwrite=True)
    register_task(TaskSpec(**kw), overwrite=True)


def write_task(root, key=TASK, n=8, answers=4):
    """``n`` questions on JPEGs of one size in the cached-pickle layout, a
    vocabulary file; the task registered in both packages."""
    data_root = root / "data"
    task_dir = data_root / key
    (task_dir / "cached_vqa_data").mkdir(parents=True)
    img_dir = data_root / "vizwiz" / "images"
    img_dir.mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(0)
    examples = []
    for i in range(n):
        name = f"{key}_{i}.jpg"
        Image.fromarray(rng.randint(0, 255, (48, 56, 3), dtype=np.uint8)).save(img_dir / name)
        examples.append({"question_id": i, "image_id": name, "question": f"what is the thing {i}",
                         "labels": [i % answers], "scores": [1.0], "answers": ["a"]})
    with open(task_dir / "cached_vqa_data" / "vqa_train_small_fed.pkl", "wb") as f:
        pickle.dump(examples, f)
    vocab = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "what", "is", "the", "thing"]
    vocab_file = root / "vocab.txt"
    vocab_file.write_text("\n".join(vocab + [str(i) for i in range(10)]))
    register(key, task_dir)
    return data_root, vocab_file


def smoke_argv(data_root, vocab_file, out, *extra):
    return ["--encoder_name", "vilt", "--optimizer_mode", "dat", "--ordered_cl_tasks", TASK,
            "--climb_data_dir", str(data_root), "--vocab_file", str(vocab_file),
            "--output_dir", str(out / "logs"), "--checkpoint_dir", str(out / "ckpt"),
            "--batch_size", "4", "--comm_rounds", str(ROUNDS), "--eval_every", "1",
            "--num_epochs", "2", "--lr", str(LR), "--dtype", "float32", "--wandb_freq", "1",
            "--smoke", "--use_fused_dat", *extra]


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    return write_task(tmp_path_factory.mktemp("torch_cli"))


def jax_initial_params(monkeypatch):
    """Record what the JAX CLI's ``init_vilt_params`` returns."""
    import feddat_tpu.models.vilt as jv

    seen, init = {}, jv.init_vilt_params

    def recording(*a, **kw):
        seen["params"] = init(*a, **kw)
        return seen["params"]

    monkeypatch.setattr(jv, "init_vilt_params", recording)
    return seen


@pytest.fixture(scope="module")
def runs(task, tmp_path_factory):
    data_root, vocab_file = task
    out_j, out_t = tmp_path_factory.mktemp("jax_run"), tmp_path_factory.mktemp("port_run")
    with pytest.MonkeyPatch.context() as mp:
        seen = jax_initial_params(mp)
        assert jcli.main(smoke_argv(data_root, vocab_file, out_j)) == 0
        start = vilt_from_flax(jax.tree_util.tree_map(np.asarray, seen["params"]))
        mp.setattr(tcli, "init_params", lambda args, model, cfg: dict(start))
        assert tcli.main(smoke_argv(data_root, vocab_file, out_t, "--device", "cpu")) == 0
    return out_j, out_t


def _one(directory, suffix):
    found = sorted(p for p in os.listdir(directory) if p.endswith(suffix))
    assert len(found) == 1, os.listdir(directory)
    return found[0]


def test_run_name_matches_jax(runs):
    out_j, out_t = runs
    names = [_one(o / "logs", ".history.json") for o in runs]
    assert names[0] == names[1] == f"vilt_dat_bs4_lr{LR}_rounds{ROUNDS}x1_seed1.history.json"
    assert sorted(os.listdir(out_t / "logs")) == sorted(os.listdir(out_j / "logs"))


def test_meta_json_is_byte_for_byte_jax(runs):
    out_j, out_t = runs
    assert (out_t / "ckpt" / "meta.json").read_bytes() == (out_j / "ckpt" / "meta.json").read_bytes()


def _records(out, kind):
    path = out / "logs" / _one(out / "logs", ".metrics.jsonl")
    return [r for r in map(json.loads, path.read_text().splitlines()) if r["kind"] == kind]


def test_step_losses_match_jax(runs):
    j_steps, t_steps = (_records(o, "step") for o in runs)
    assert len(t_steps) == len(j_steps) == ROUNDS * 2
    for j, t in zip(j_steps, t_steps):
        assert t.keys() == j.keys() and (t["task"], t["step"]) == (j["task"], j["step"])
        for k in ("loss", "loss_shared", "lr"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=f"step {j['step']}: {k}")
    assert [r["kind"] for r in map(json.loads, (runs[1] / "logs" / _one(runs[1] / "logs", ".jsonl"))
                                   .read_text().splitlines())][0] == "run_start"


def test_history_scores_match_jax(runs):
    j_hist, t_hist = (json.loads((o / "logs" / _one(o / "logs", ".history.json")).read_text())
                      for o in runs)
    assert [e["round"] for e in t_hist] == [e["round"] for e in j_hist] == list(range(ROUNDS))
    for j, t in zip(j_hist, t_hist):
        assert len(t["scores"][TASK]) == 3
        np.testing.assert_allclose(t["scores"][TASK], j["scores"][TASK], rtol=0, atol=1e-9)
    rounds = _records(runs[1], "round")
    assert [r["scores"] for r in rounds] == [e["scores"] for e in t_hist]


def test_last_server_parameters_match_jax(runs):
    from feddat_tpu.utils.checkpointing import restore_federated_state as jax_restore
    from feddat_tpu_torch.utils.checkpointing import restore_federated_state

    out_j, out_t = runs
    rnd_j, server_j, _, _ = jax_restore(str(out_j / "ckpt"))
    rnd_t, server_t, _, _ = restore_federated_state(str(out_t / "ckpt"), device="cpu")
    assert rnd_j == rnd_t == ROUNDS - 1
    want = vilt_from_flax(jax.tree_util.tree_map(np.asarray, server_j))
    assert server_t.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(server_t[k].numpy(), want[k].numpy(), rtol=1e-4, atol=LR / 50,
                                   err_msg=k)


def test_a_relaunch_resumes(runs, task, caplog):
    """The same command with more rounds resumes at the next round from
    ``--checkpoint_dir``, and its metrics stream starts a new run."""
    data_root, vocab_file = task
    _, out_t = runs
    argv = smoke_argv(data_root, vocab_file, out_t, "--device", "cpu")
    argv[argv.index("--comm_rounds") + 1] = str(ROUNDS + 1)
    with caplog.at_level("INFO", logger="feddat_tpu_torch"):
        assert tcli.main(argv) == 0
    assert f"resumed from checkpoint at round {ROUNDS - 1}" in caplog.text
    name = f"vilt_dat_bs4_lr{LR}_rounds{ROUNDS + 1}x1_seed1"
    history = json.loads((out_t / "logs" / f"{name}.history.json").read_text())
    assert [e["round"] for e in history] == [ROUNDS]
    kinds = [json.loads(line)["kind"] for line in
             (out_t / "logs" / f"{name}.metrics.jsonl").read_text().splitlines()]
    assert kinds == ["run_start", "step", "step", "round"]


def test_do_single_runs(task, tmp_path):
    data_root, vocab_file = task
    argv = smoke_argv(data_root, vocab_file, tmp_path, "--device", "cpu", "--do_single")
    argv[argv.index("--comm_rounds") + 1] = "1"
    assert tcli.main(argv) == 0
    history = json.loads((tmp_path / "logs" / _one(tmp_path / "logs", ".history.json")).read_text())
    assert len(history) == 1 and history[0]["round"] == -1 and history[0]["single_task"]
    assert len(history[0]["scores"][TASK]) == 3


def script_argv(path):
    """The arguments a launch script passes to ``python -m feddat_tpu.cli``,
    with each ``${VAR:-default}`` at its default and ``"$@"`` dropped."""
    text = pathlib.Path(path).read_text().replace("\\\n", " ")
    line = next(ln for ln in text.splitlines() if "python -m feddat_tpu.cli" in ln)
    line = re.sub(r"\$\{\w+:-([^}]*)\}", r"\1", line.split("python -m feddat_tpu.cli", 1)[1])
    return [a for a in shlex.split(line) if a != "$@"]


SCRIPTS = sorted((ROOT / "scripts").glob("train_*.sh"))


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda p: p.name)
def test_launch_scripts_parse_as_in_jax(script):
    argv = script_argv(script)
    assert "--encoder_name" in argv
    got = vars(tcli.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == vars(jcli.build_parser().parse_args(argv))


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.choices, a.type, a.nargs, a.required,
                     type(a).__name__) for a in parser._actions}


def test_the_parser_has_every_jax_flag():
    """Same names, choices, defaults, types and arities; one flag more."""
    got, want = _options(tcli.build_parser()), _options(jcli.build_parser())
    assert got.pop("device") == (("--device",), "cuda", ["cuda", "cpu"], None, None, False,
                                 "_StoreAction")
    assert got == want
    assert len(SCRIPTS) == 4


REFUSALS = [
    # tensor parallelism runs; started alone, a world of one has one device
    # for a model axis of 2: JAX's mesh error, and no fall back
    (["--tp", "2"], ValueError, "^1 devices not divisible by model=2$"),
]


@pytest.mark.parametrize("extra,error,message", REFUSALS, ids=[" ".join(e) for e, _, _ in REFUSALS])
def test_refusals_exit_before_a_model_is_built(extra, error, message, task, tmp_path, monkeypatch):
    def never(*a, **kw):
        raise AssertionError("a model or client was built")

    for fn in ("build_model", "build_clients", "init_params"):
        monkeypatch.setattr(tcli, fn, never)
    argv = ["--encoder_name", "vilt", "--ordered_cl_tasks", TASK, "--device", "cpu",
            "--output_dir", str(tmp_path / "logs")]
    with pytest.raises(error, match=message):
        tcli.main(argv + extra)
    assert not (tmp_path / "logs").exists()


TWO = f"{TASK},torch_cli_task2"
SPMD_ERRORS = [
    (["--engine", "spmd", "--ordered_cl_tasks", TWO, "--mesh_data", "1"], ValueError,
     "^need 2 devices, have 1$"),
    (["--engine", "spmd", "--ordered_cl_tasks", TWO], ValueError,
     "^1 devices not divisible by 2 clients$"),
    (["--engine", "spmd", "--mesh_clients", "2", "--mesh_data", "1"], ValueError,
     "^need 2 devices, have 1$"),
    (["--engine", "spmd", "--mesh_data", "2"], ValueError, "^need 2 devices, have 1$"),
    (["--multihost"], RuntimeError, "refusing to fall back to a world of one"),
    (["--engine", "spmd", "--do_single"], ValueError, "--do_single is a per-task centralized"),
    (["--engine", "spmd", "--canvas_bucket"], SystemExit, "--canvas_bucket emits per-batch"),
]


@pytest.mark.parametrize("extra,error,match", SPMD_ERRORS,
                         ids=[" ".join(e).replace(TWO, "2 tasks") for e, _, _ in SPMD_ERRORS])
def test_spmd_errors_come_before_a_model_is_built(extra, error, match, task, tmp_path, monkeypatch):
    """The mesh's errors are JAX's word for word (a world of one here), and
    the process group the launch started is gone after them."""
    register("torch_cli_task2", tmp_path)
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)

    def never(*a, **kw):
        raise AssertionError("a model or client was built")

    for fn in ("build_model", "build_clients", "init_params"):
        monkeypatch.setattr(tcli, fn, never)
    argv = ["--encoder_name", "vilt", "--ordered_cl_tasks", TASK, "--device", "cpu",
            "--output_dir", str(tmp_path / "logs")]
    with pytest.raises(error, match=match):
        tcli.main(argv + extra)
    assert not (tmp_path / "logs").exists() and not dist.is_initialized()


@pytest.fixture(scope="module")
def spmd_runs(task, tmp_path_factory):
    """Both CLIs' ``--engine spmd`` on one client: JAX on one device of a
    (1, 1) mesh, the port in a world of one."""
    data_root, vocab_file = task
    out_j, out_t = tmp_path_factory.mktemp("jax_spmd"), tmp_path_factory.mktemp("port_spmd")
    spmd = ("--engine", "spmd", "--mesh_data", "1")
    with pytest.MonkeyPatch.context() as mp:
        seen = jax_initial_params(mp)
        assert jcli.main(smoke_argv(data_root, vocab_file, out_j, *spmd)) == 0
        start = vilt_from_flax(jax.tree_util.tree_map(np.asarray, seen["params"]))
        mp.setattr(tcli, "init_params", lambda args, model, cfg: dict(start))
        assert tcli.main(smoke_argv(data_root, vocab_file, out_t, "--device", "cpu", *spmd)) == 0
    assert not dist.is_initialized()
    return out_j, out_t


def test_spmd_launch_matches_jax_steps_and_scores(spmd_runs):
    j_steps, t_steps = (_records(o, "step") for o in spmd_runs)
    assert len(t_steps) == len(j_steps) == ROUNDS * 2
    for j, t in zip(j_steps, t_steps):
        assert (t["task"], t["step"]) == (j["task"], j["step"]) == ("spmd", t["step"])
        for k in ("loss", "loss_shared", "lr"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=f"step {j['step']}: {k}")
    j_hist, t_hist = (json.loads((o / "logs" / _one(o / "logs", ".history.json")).read_text())
                      for o in spmd_runs)
    assert [e["round"] for e in t_hist] == [e["round"] for e in j_hist] == list(range(ROUNDS))
    for j, t in zip(j_hist, t_hist):
        np.testing.assert_allclose(t["scores"][TASK], j["scores"][TASK], rtol=0, atol=1e-9)


def test_spmd_checkpoint_is_jaxs_stacked_client_bank(spmd_runs):
    from feddat_tpu.utils.checkpointing import restore_federated_state as jax_restore
    from feddat_tpu_torch.utils.checkpointing import load_meta, restore_federated_state

    out_j, out_t = spmd_runs
    assert load_meta(str(out_t / "ckpt"))["engine"] == "spmd"
    assert (out_t / "ckpt" / "meta.json").read_bytes() == (out_j / "ckpt" / "meta.json").read_bytes()
    rnd_j, backbone_j, personal_j, _ = jax_restore(str(out_j / "ckpt"))
    rnd_t, backbone_t, personal_t, _ = restore_federated_state(str(out_t / "ckpt"), device="cpu")
    assert rnd_j == rnd_t == ROUNDS - 1 and set(personal_t) == {"stacked_clients"}
    for got, want in ((backbone_t, backbone_j),
                      ({k: v[0] for k, v in personal_t["stacked_clients"].items()},
                       jax.tree_util.tree_map(lambda x: np.asarray(x)[0],
                                              personal_j["stacked_clients"]))):
        want = vilt_from_flax(jax.tree_util.tree_map(np.asarray, want))
        assert got.keys() == want.keys()
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=LR / 50,
                                       err_msg=k)


# ViLT-BERT on the VQA client (the fused step: its text BERT runs
# deterministic there in both packages, so the runs match exactly), and the
# mixed set of the other trainers' tasks on the standard DAT step (the
# multiple-choice head's dropout off on both sides: the packages draw their
# masks from different generators)
LAUNCHES = {
    "viltbert-vqa": ("viltbert", TASK, viltbert_from_flax),
    "vilt-nlvr2,snli-ve,vcr,vqa": ("vilt", "nlvr2,snli-ve,vcr,vqa", vilt_from_flax),
}


@pytest.fixture(scope="module", params=list(LAUNCHES))
def launched(request, task, tmp_path_factory):
    encoder, tasks, bridge = LAUNCHES[request.param]
    data_root, vocab_file = task
    if tasks != TASK:
        data_root = tmp_path_factory.mktemp("classification")
        chip_smoke.write_classification_dataset(str(data_root), 0, CLS_COUNTS, CLS_SIZES)
        vocab_file = ROOT / "tests" / "fixtures" / "vocab30k.txt"
    out_j, out_t = tmp_path_factory.mktemp("jax_cls"), tmp_path_factory.mktemp("port_cls")

    def argv(out, *extra):
        a = smoke_argv(data_root, vocab_file, out, *extra)
        a[a.index("--encoder_name") + 1] = encoder
        a[a.index("--ordered_cl_tasks") + 1] = tasks
        return a

    with pytest.MonkeyPatch.context() as mp:
        head_dropout_off(mp)
        seen = jax_initial_params(mp)
        assert jcli.main(argv(out_j)) == 0
        start = bridge(jax.tree_util.tree_map(np.asarray, seen["params"]))
        mp.setattr(tcli, "init_params", lambda args, model, cfg: dict(start))
        assert tcli.main(argv(out_t, "--device", "cpu")) == 0
    return tasks.split(","), out_j, out_t


def test_classification_launches_step_losses_match_jax(launched):
    tasks, *outs = launched
    j_steps, t_steps = (_records(o, "step") for o in outs)
    assert len(t_steps) == len(j_steps) >= ROUNDS * len(tasks)
    assert {r["task"] for r in t_steps} == set(tasks)
    for j, t in zip(j_steps, t_steps):
        assert t.keys() == j.keys() and (t["task"], t["step"]) == (j["task"], j["step"])
        for k in ("loss", "loss_shared", "lr"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=f"step {j['step']}: {k}")


def test_classification_launches_scores_and_meta_match_jax(launched):
    tasks, out_j, out_t = launched
    j_hist, t_hist = (json.loads((o / "logs" / _one(o / "logs", ".history.json")).read_text())
                      for o in (out_j, out_t))
    assert [e["round"] for e in t_hist] == [e["round"] for e in j_hist] == list(range(ROUNDS))
    for j, t in zip(j_hist, t_hist):
        for key in tasks:
            assert len(t["scores"][key]) == 3
            np.testing.assert_allclose(t["scores"][key], j["scores"][key], rtol=0, atol=1e-9)
    assert (out_t / "ckpt" / "meta.json").read_bytes() == (out_j / "ckpt" / "meta.json").read_bytes()


@pytest.mark.parametrize("impl", ["layer", "fused", "flash"])
def test_float32_on_the_plain_route_or_the_cpu_is_not_refused(impl, tmp_path):
    """Every kernel (#1-#9) takes float32: float32 on "auto", and on a kernel
    route on the card, on the CPU (its plain version) and with --smoke (whose
    model is the JAX CLI's float32 "auto" one), passes the check."""
    args = tcli.build_parser().parse_args(["--encoder_name", "vilt", "--dtype", "float32"])
    tcli.refuse_unported(args)
    for extra in (["--device", "cpu"], ["--smoke"], ["--device", "cuda"]):
        args = tcli.build_parser().parse_args(
            ["--encoder_name", "vilt", "--dtype", "float32", "--attn_impl", impl, *extra])
        tcli.refuse_unported(args)


def test_pretrained_vilt_backbone_is_the_jax_clis(task, tmp_path, monkeypatch):
    """``--pretrained_model_name`` on a synthetic HF ViLT state dict: the
    port's ``init_params`` gives the backbone (every ``vilt.*`` tensor but
    the adapters) that the JAX CLI's conversion and merge give, bit for bit;
    the adapters and the head keep the fresh initialisation."""
    import feddat_tpu.utils.checkpoint_convert as jcc

    data_root, vocab_file = task
    args = tcli.build_parser().parse_args(
        smoke_argv(data_root, vocab_file, tmp_path, "--device", "cpu"))
    from feddat_tpu_torch.configs.core import PEFTMode
    from feddat_tpu_torch.models.vilt import TaskHeadSpec

    model, cfg, _ = tcli.build_model(args, PEFTMode.DAT, {TASK: TaskHeadSpec(100)}, torch.device("cpu"))
    path = tmp_path / "vilt_hf.bin"
    torch.save(_hf_vilt_state_dict(np.random.RandomState(3), grid=12, h=cfg.hidden_size,
                                   inter=cfg.intermediate_size, vocab=cfg.vocab_size,
                                   text_len=cfg.max_text_len, p=cfg.patch_size), path)
    fresh = tcli.init_params(args, model, cfg)
    args.pretrained_model_name = str(path)
    got = tcli.init_params(args, model, cfg)

    merged, merge = {}, jcc.merge_pretrained
    monkeypatch.setattr(jcc, "merge_pretrained",
                        lambda *a, **kw: merged.setdefault("params", merge(*a, **kw)))
    argv = smoke_argv(data_root, vocab_file, tmp_path / "jax", "--pretrained_model_name", str(path))
    argv[argv.index("--comm_rounds") + 1] = "0"
    assert jcli.main(argv) == 0
    want = vilt_from_flax(jax.tree_util.tree_map(np.asarray, merged["params"]))
    backbone = [k for k in want if k.startswith("vilt.") and ".adapter." not in k]
    assert got.keys() == want.keys() and len(backbone) > 30
    for k in backbone:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["vilt.pooler.weight"], torch.load(path)["pooler.dense.weight"])
    for k in set(got) - set(backbone):  # the adapters and the head
        assert torch.equal(got[k], fresh[k]), k
