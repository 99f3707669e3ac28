"""The port's CLI against the JAX package's with ALBEF on the CPU: the same
``--smoke --use_fused_dat --dtype float32 --cache_images`` command for one
round of ``albef_no_distill`` DAT on a task written to disk here, its answer
bank (8 answers) smaller than the rank-answer k=64, from JAX's initial
parameters (``utils/param_bridge.py``).  They agree on ``meta.json`` byte for
byte (with its ``answer_lists``), the ``step`` records' losses (rtol 1e-4),
the rank-answer scores (atol 1e-9) and the server parameters (rtol 1e-4,
atol lr/50, as in tests/test_torch_federated.py)."""

import json
import pickle

import jax
import numpy as np
import pytest

import feddat_tpu.cli as jcli
import feddat_tpu_torch.cli as tcli
from feddat_tpu_torch.utils.param_bridge import albef_from_flax

from test_torch_cli import TASK, _one, _records, write_task

LR = 5e-3
ANSWERS = "abcdefgh"


def albef_argv(data_root, vocab_file, out, *extra):
    return ["--encoder_name", "albef_no_distill", "--optimizer_mode", "dat",
            "--ordered_cl_tasks", TASK, "--climb_data_dir", str(data_root),
            "--vocab_file", str(vocab_file), "--output_dir", str(out / "logs"),
            "--checkpoint_dir", str(out / "ckpt"), "--batch_size", "4", "--comm_rounds", "1",
            "--eval_every", "1", "--num_epochs", "1", "--lr", str(LR), "--dtype", "float32",
            "--wandb_freq", "1", "--smoke", "--use_fused_dat", "--cache_images", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import feddat_tpu.models.albef as ja

    root = tmp_path_factory.mktemp("torch_cli_albef")
    data_root, vocab_file = write_task(root)
    with open(data_root / TASK / "ans2label.pkl", "wb") as f:
        pickle.dump({c: i for i, c in enumerate(ANSWERS)}, f)
    out_j, out_t = root / "jax", root / "port"
    seen, init = {}, ja.init_albef_params
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ja, "init_albef_params",
                   lambda *a, **kw: seen.setdefault("params", init(*a, **kw)))
        assert jcli.main(albef_argv(data_root, vocab_file, out_j)) == 0
        start = albef_from_flax(jax.tree_util.tree_map(np.asarray, seen["params"]))
        mp.setattr(tcli, "init_params", lambda args, model, cfg: dict(start))
        assert tcli.main(albef_argv(data_root, vocab_file, out_t, "--device", "cpu")) == 0
    return out_j, out_t


def test_albef_meta_json_is_byte_for_byte_jax(runs):
    out_j, out_t = runs
    got = (out_t / "ckpt" / "meta.json").read_bytes()
    assert got == (out_j / "ckpt" / "meta.json").read_bytes()
    assert json.loads(got)["answer_lists"] == {TASK: list(ANSWERS)}


def test_albef_step_losses_and_scores_match_jax(runs):
    j_steps, t_steps = (_records(o, "step") for o in runs)
    assert len(t_steps) == len(j_steps) == 2
    for j, t in zip(j_steps, t_steps):
        assert t.keys() == j.keys()
        for k in ("loss", "loss_shared", "lr"):
            np.testing.assert_allclose(t[k], j[k], rtol=1e-4, err_msg=f"step {j['step']}: {k}")
    j_hist, t_hist = (json.loads((o / "logs" / _one(o / "logs", ".history.json")).read_text())
                      for o in runs)
    assert [e["round"] for e in t_hist] == [e["round"] for e in j_hist] == [0]
    assert len(t_hist[0]["scores"][TASK]) == 3
    np.testing.assert_allclose(t_hist[0]["scores"][TASK], j_hist[0]["scores"][TASK], rtol=0, atol=1e-9)


def test_albef_server_parameters_match_jax(runs):
    from feddat_tpu.utils.checkpointing import restore_federated_state as jax_restore
    from feddat_tpu_torch.utils.checkpointing import restore_federated_state

    out_j, out_t = runs
    _, server_j, _, _ = jax_restore(str(out_j / "ckpt"))
    _, server_t, _, _ = restore_federated_state(str(out_t / "ckpt"), device="cpu")
    want = albef_from_flax(jax.tree_util.tree_map(np.asarray, server_j))
    assert server_t.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(server_t[k].numpy(), want[k].numpy(), rtol=1e-4, atol=LR / 50,
                                   err_msg=k)


def test_albef_smoke_from_the_ports_own_initialisation(tmp_path):
    """The port's CLI alone, its own ``init_params`` (``init_albef_params``
    on the smoke model, whose cross-attention reads the 32-wide ViT): one
    round of rank-answer DAT on the native-finalized u8 cache."""
    data_root, vocab_file = write_task(tmp_path)
    with open(data_root / TASK / "ans2label.pkl", "wb") as f:
        pickle.dump({c: i for i, c in enumerate(ANSWERS)}, f)
    assert tcli.main(albef_argv(data_root, vocab_file, tmp_path, "--device", "cpu")) == 0
    history = json.loads((tmp_path / "logs" / _one(tmp_path / "logs", ".history.json")).read_text())
    scores = history[-1]["scores"][TASK]
    assert len(scores) == 3 and all(0.0 <= s <= 100.0 for s in scores)
    assert [r["kind"] for r in _records(tmp_path, "step")] == ["step", "step"]
