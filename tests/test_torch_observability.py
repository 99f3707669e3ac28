"""The port's observability, results and seeding utilities against the JAX
package's on the CPU: the run name, the results tables (for the same
history files), the metrics stream's record kinds and keys, the logger's
handlers, ``seed_everything``; and an engine run with ``profile_dir``, whose
trace file holds the round's CPU events and whose parameters are bitwise an
unprofiled run's."""

import json
import logging
import random

import numpy as np
import pytest
import torch

from feddat_tpu.configs import core as jax_core
from feddat_tpu.utils import observability as jax_obs
from feddat_tpu.utils import results as jax_results
from feddat_tpu.utils import seeding as jax_seeding
from feddat_tpu_torch.configs import core
from feddat_tpu_torch.utils import observability as obs
from feddat_tpu_torch.utils import results
from feddat_tpu_torch.utils import seeding

from conftest import TINY_VILT


def _config(mod, **kw):
    return mod.TrainConfig(encoder_name="albef_no_distill", peft_mode=mod.PEFTMode.LORA, batch_size=48,
                           optimizer=mod.OptimizerConfig(lr=3e-5),
                           federated=mod.FederatedConfig(comm_rounds=7, local_epochs=2), seed=4, **kw)


def test_experiment_name_is_jax():
    assert obs.experiment_name(_config(core)) == jax_obs.experiment_name(_config(jax_core)) \
        == "albef_no_distill_lora_bs48_lr3e-05_rounds7x2_seed4"


HISTORIES = [
    [{"round": 0, "scores": {"vizwiz": [10.0, 9.0, 8.0], "gqa": 40.5}},
     {"round": 1, "scores": {"vizwiz": [20.25, 1.0, 2.0], "gqa": 41.0}}],
    [{"round": 1, "scores": {"vizwiz": [30.5, 0.0, 0.0], "gqa": 39.0, "art": 12.125}}],
    [{"round": -1, "scores": {"vizwiz": [25.0, 3.0, 3.0]}, "single_task": True}],
    [],
]


def test_results_tables_print_what_jax_prints(tmp_path, capsys):
    paths = []
    for i, h in enumerate(HISTORIES):
        paths.append(str(tmp_path / f"run{i}.history.json"))
        with open(paths[-1], "w") as f:
            json.dump(h, f)
    table = results.mean_std_table(results.load_histories(paths))
    assert table == jax_results.mean_std_table(jax_results.load_histories(paths))
    assert table["vizwiz"]["n"] == 3 and table["average"]["n"] == 3
    assert results.format_table(table) == jax_results.format_table(table)
    assert results.main(paths) == 0
    printed = capsys.readouterr().out
    assert jax_results.main(paths) == 0
    assert printed == capsys.readouterr().out == results.format_table(table) + "\n"


class _Scalar:
    """A stand-in device scalar that counts its read-backs."""

    reads = 0

    def __init__(self, v):
        self.v = v

    def __float__(self):
        _Scalar.reads += 1
        return float(self.v)


def _drive(logger, scalar):
    for i in range(5):
        logger.step({"loss": scalar(1.5 + i), "lr": scalar(1e-4)}, 4, "vizwiz")
    logger.round(0, {"vizwiz": [1.0, 2.0, 3.0]}, 0.25)
    logger.close()


def test_metrics_logger_writes_jax_records(tmp_path):
    """The same record kinds, keys and values (but the clocks); a scalar is
    read back only when its record is written."""
    _Scalar.reads = 0
    _drive(obs.MetricsLogger(str(tmp_path / "port.jsonl"), log_every=2), _Scalar)
    assert _Scalar.reads == 4  # two step records of two scalars
    _drive(jax_obs.MetricsLogger(str(tmp_path / "jax.jsonl"), log_every=2), float)
    _drive(obs.MetricsLogger(str(tmp_path / "port.jsonl"), log_every=2),
           lambda v: torch.tensor(v, dtype=torch.float32))  # a second run appends
    port = [json.loads(s) for s in (tmp_path / "port.jsonl").read_text().splitlines()]
    want = [json.loads(s) for s in (tmp_path / "jax.jsonl").read_text().splitlines()]
    assert [r["kind"] for r in want] == ["run_start", "step", "step", "round"]
    assert [r["kind"] for r in port] == [r["kind"] for r in want] * 2
    for got in (port[:4], port[4:]):
        for g, w in zip(got, want):
            assert g.keys() == w.keys()
            g, w = ({k: v for k, v in r.items() if k not in ("ts", "samples_per_sec")} for r in (g, w))
            assert g == (pytest.approx(w, rel=1e-6) if w["kind"] == "step" else w)


def test_setup_logger_gives_process_zero_one_handler_of_each_kind(tmp_path):
    logger = logging.getLogger("feddat_tpu_torch")
    before = list(logger.handlers)  # an earlier CLI run in this process may have set some
    for h in before:
        logger.removeHandler(h)
    try:
        for _ in range(2):
            got = obs.setup_logger(str(tmp_path), run_name="run")
        assert got is logger
        assert sorted(type(h).__name__ for h in logger.handlers) == ["FileHandler", "StreamHandler"]
        logging.getLogger("feddat_tpu_torch.federated.engine").info("from a module logger")
        for h in logger.handlers:
            h.flush()
        assert "from a module logger" in (tmp_path / "run.log").read_text()
    finally:
        for h in list(logger.handlers):
            h.close()
            logger.removeHandler(h)
        for h in before:
            logger.addHandler(h)


def test_seed_everything_is_jax_and_leaves_torch_alone():
    state = torch.random.get_rng_state()
    assert seeding.process_index() == 0
    assert seeding.seed_everything(7) == jax_seeding.seed_everything(7) == 7
    seeding.seed_everything(7)
    ours = (random.random(), np.random.rand())
    jax_seeding.seed_everything(7)
    assert ours == (random.random(), np.random.rand())
    assert seeding.seed_everything(7, per_process_offset=False) == 7
    assert torch.equal(torch.random.get_rng_state(), state)


def _trainer(profile_dir=None):
    from feddat_tpu_torch.data.synthetic import SyntheticVQAClient
    from feddat_tpu_torch.federated.engine import FederatedTrainer
    from feddat_tpu_torch.models.vilt import TaskHeadSpec, ViltContinualLearner, init_vilt_params

    from test_torch_vilt import port_config

    heads = {f"c{i}": TaskHeadSpec(num_labels=16) for i in range(2)}
    model = init_vilt_params(ViltContinualLearner(port_config(TINY_VILT), heads), 0)
    clients = {k: SyntheticVQAClient(k, num_train=8, num_eval=8, num_labels=16,
                                     vocab_size=TINY_VILT.vocab_size, text_len=TINY_VILT.max_text_len,
                                     image_size=TINY_VILT.image_size, batch_size=4, seed=i)
               for i, k in enumerate(heads)}
    cfg = core.TrainConfig(peft_mode=core.PEFTMode.DAT, optimizer=core.OptimizerConfig(lr=5e-3),
                           federated=core.FederatedConfig(comm_rounds=2, local_epochs=1, eval_every=1),
                           num_epochs=2, seed=0)
    return FederatedTrainer(model, None, clients, cfg, use_fused_dat=True, device="cpu",
                            profile_dir=profile_dir)


def test_a_profiled_engine_run_writes_a_trace_of_its_first_round(tmp_path):
    profiled, plain = _trainer(str(tmp_path / "profile")), _trainer()
    assert profiled.run() == plain.run()
    traces = list((tmp_path / "profile").glob("*.pt.trace.json"))
    assert len(traces) == 1  # the first round only
    events = json.loads(traces[0].read_text())["traceEvents"]
    cpu_ops = [e for e in events if e.get("cat") == "cpu_op" and e.get("ph") == "X"]
    assert len(cpu_ops) > 100 and any(e["name"] == "aten::mm" for e in cpu_ops)
    for k, v in plain.server_params.items():
        assert torch.equal(profiled.server_params[k], v), k
