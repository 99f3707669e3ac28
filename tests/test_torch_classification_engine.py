"""The ViLT family's classification clients on the port's engines against the
JAX package's on the CPU, at the CLIs' ``--smoke`` widths (float32,
``"auto"``), on a dataset written under a tmp dir by
``chip_smoke.py::write_classification_dataset``.

* One sequential round of a mixed client set, NLVR2 + SNLI-VE + VCR +
  low-shot VQAv2, each client built by its CLI's ``build_clients`` and
  trained by the standard DAT step with its task's hooks (CE and accuracy;
  VQAv2's BCE and VQA score) and its task's optimizer settings and epoch
  horizon: every step's losses and lr (rtol 1e-4), the server parameters
  and each personal store (rtol 1e-4, atol lr/20), the three DAT scores
  (atol 1e-9, counts of hits).  Adam's first updates move an element by
  about lr whatever its gradient's size above ``adam_eps`` (1e-8), so the
  two packages' summation-order noise in a gradient element near that size
  moves it by a fraction of lr (tests/test_torch_federated.py's reason for
  its lr/50 at 2 rounds x 2 steps of lr 5e-3; here one element of 32 of a
  VCR adapter bias at 0.03 lr, lr 1e-4).  The multiple-choice head's bias
  has an exactly zero gradient (the choices share it and the softmax
  cancels it), so its updates are rounding noise in both packages: it is
  held within 2 lr per update.  That head's dropout (0.1, masks drawn by
  different generators in the two packages) is off on both sides.
* The SPMD engine in a world of 2 gloo ranks (``tests/torch_spmd_worker.py``)
  on two SNLI-VE clients of one head against JAX's SPMD engine on a (2, 1)
  mesh, with the CE forward and the accuracy metric: each client's
  partitions and the scores at the same tolerances.
* JAX's errors word for word: a non-uniform head under ``--engine spmd``,
  mixed optimizer configs under ``--engine spmd``, an ALBEF encoder with a
  ViLT-family task."""

import dataclasses
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

import feddat_tpu.cli as jcli
import feddat_tpu.models.vilt as jvilt
import feddat_tpu_torch.cli as tcli
import feddat_tpu_torch.models.vilt as tvilt
from feddat_tpu.configs.core import FederatedConfig as JaxFederatedConfig
from feddat_tpu.configs.core import OptimizerConfig as JaxOptimizerConfig
from feddat_tpu.configs.core import PEFTMode as JaxPEFTMode
from feddat_tpu.configs.core import TrainConfig as JaxTrainConfig
from feddat_tpu.configs.core import ViltModelConfig as JaxViltConfig
from feddat_tpu.configs.core import adapter_spec_for_mode
from feddat_tpu.configs.tasks import TASK_CONFIGS as JAX_TASKS
from feddat_tpu.configs.tasks import TaskSpec as JaxTaskSpec
from feddat_tpu.configs.tasks import register_task as jax_register_task
from feddat_tpu.data.tokenizer import WordPieceTokenizer as JaxTokenizer
from feddat_tpu.federated.engine import FederatedTrainer as JaxTrainer
from feddat_tpu.federated.spmd import SPMDFederatedTrainer as JaxSPMD
from feddat_tpu.models.vilt import TaskHeadSpec as JaxHeadSpec
from feddat_tpu.models.vilt import ViltContinualLearner as JaxVilt
from feddat_tpu.parallel.mesh import make_mesh as jax_make_mesh
from feddat_tpu.train.evaluation import make_eval_step as jax_make_eval_step
from feddat_tpu.train.forwards import make_vilt_forward as jax_make_vilt_forward
from feddat_tpu.train.trainers import resolve_trainer as jax_resolve_trainer
from feddat_tpu_torch.configs.core import FederatedConfig, OptimizerConfig, PEFTMode, TrainConfig
from feddat_tpu_torch.configs.tasks import TASK_CONFIGS, TaskSpec, register_task
from feddat_tpu_torch.data.tokenizer import WordPieceTokenizer
from feddat_tpu_torch.federated.spmd import FED_HEAD_KEY
from feddat_tpu_torch.models.vilt import TaskHeadSpec
from feddat_tpu_torch.utils.param_bridge import vilt_from_flax

from test_torch_remat import random_like_init
from torch_spmd_worker import spawn

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke  # noqa: E402

VOCAB = str(ROOT / "tests" / "fixtures" / "vocab30k.txt")
# at B=4 (NLVR2's halved batch 2): 2, 2, 1 and 1 train steps; VCR and VQAv2
# keep 5% of theirs
COUNTS = {"nlvr2": (4, 3), "snli-ve": (8, 5), "vcr": (80, 60), "vqa": (80, 60)}
SIZES = ((40, 30), (30, 52), (64, 64))
MIXED = ("nlvr2", "snli-ve", "vcr", "vqa")
CPU = torch.device("cpu")


class Recorder:
    """The engines' metrics logger: every step's scalars, per client."""

    def __init__(self):
        self.steps = []

    def step(self, metrics, batch_size, task_key=""):
        self.steps.append((task_key, {k: float(metrics[k]) for k in ("loss", "loss_shared", "lr")}))

    def round(self, *args):
        pass


class _NoDropoutLinen:
    """flax.linen with ``Dropout`` at rate 0, for JAX's ViLT module (only the
    multiple-choice head's dropout has a non-zero rate there)."""

    def __init__(self, nn):
        self._nn = nn

    def __getattr__(self, name):
        return getattr(self._nn, name)

    def Dropout(self, rate):  # noqa: N802 (flax's name)
        return self._nn.Dropout(0.0)


def head_dropout_off(mp):
    mp.setattr(jvilt, "nn", _NoDropoutLinen(jvilt.nn))
    mp.setattr(tvilt, "dropout", lambda x, rate, deterministic: x)


def smoke_args(parser, root, tasks, *extra):
    return parser.parse_args(["--encoder_name", "vilt", "--ordered_cl_tasks", ",".join(tasks),
                              "--climb_data_dir", str(root), "--vocab_file", VOCAB,
                              "--batch_size", "4", "--smoke", "--dtype", "float32", *extra])


def smoke_config():
    """The CLIs' ``--smoke`` ViLT (feddat_tpu/cli.py:544-556)."""
    return JaxViltConfig(hidden_size=32, num_layers=2, num_heads=4, intermediate_size=64,
                         max_text_len=16, image_size=(64, 64), patch_size=32,
                         adapter=adapter_spec_for_mode(JaxPEFTMode.DAT, 4))


def head_specs(tasks, jax_side):
    cls, registry = (JaxHeadSpec, JAX_TASKS) if jax_side else (TaskHeadSpec, TASK_CONFIGS)
    return {k: cls(num_labels=registry[k].num_labels, num_images=registry[k].num_images,
                   model_type=registry[k].model_type, num_choices=registry[k].num_choices)
            for k in tasks}


def smoke_weights(heads, batch, seed=1):
    model = JaxVilt(smoke_config(), heads)
    abstract = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), batch,
                                                 method=JaxVilt.init_all))["params"]
    return model, random_like_init(abstract, seed)


def configs(tasks, **kw):
    fed = dict(comm_rounds=1, local_epochs=1, eval_every=1)
    cfg = dict(peft_mode=PEFTMode.DAT, tasks=tuple(tasks), batch_size=4, seed=1, **kw)
    jcfg = {**cfg, "peft_mode": JaxPEFTMode.DAT}
    for k in ("optimizer",):
        if k in kw:
            jcfg[k] = JaxOptimizerConfig(**dataclasses.asdict(kw[k]))
    return (JaxTrainConfig(federated=JaxFederatedConfig(**fed), **jcfg),
            TrainConfig(federated=FederatedConfig(**fed), **cfg))


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    path = tmp_path_factory.mktemp("classification_engine")
    chip_smoke.write_classification_dataset(str(path), 0, COUNTS, SIZES)
    return path


@pytest.fixture(scope="module")
def mixed(root):
    """One round of the mixed client set on both sequential engines."""
    jargs = smoke_args(jcli.build_parser(), root, MIXED)
    targs = smoke_args(tcli.build_parser(), root, MIXED, "--device", "cpu")
    jclients, _ = jcli.build_clients(jargs, MIXED, JaxTokenizer.from_vocab_file(VOCAB))
    tclients, _ = tcli.build_clients(targs, MIXED, WordPieceTokenizer.from_vocab_file(VOCAB))
    sample = next(iter(jclients.values())).train_batches(0).__next__()
    jmodel, params = smoke_weights(head_specs(MIXED, True), sample)
    jcfg, tcfg = configs(MIXED)
    with pytest.MonkeyPatch.context() as mp:
        head_dropout_off(mp)

        def hooks(k):
            return jax_resolve_trainer("vilt", JAX_TASKS[k].trainer, answer_banks={})

        opt = {k: JaxOptimizerConfig(lr=JAX_TASKS[k].lr, weight_decay=JAX_TASKS[k].weight_decay,
                                     adam_eps=JAX_TASKS[k].adam_epsilon,
                                     warmup_ratio=JAX_TASKS[k].warmup_ratio) for k in MIXED}
        jrec = Recorder()
        jt = JaxTrainer(jmodel, params, jclients, jcfg,
                        make_forward=lambda m, k: hooks(k).make_forward(m, k),
                        make_eval=lambda m, k: jax_make_eval_step(m, k, hooks(k).metric),
                        optimizer_overrides=opt,
                        num_epochs_overrides={k: JAX_TASKS[k].num_epochs for k in MIXED},
                        metrics_logger=jrec)
        jt.run(resume=False)

        tmodel, _, _ = tcli.build_model(targs, PEFTMode.DAT, head_specs(MIXED, False), CPU)
        tmodel.load_state_dict(vilt_from_flax(params), strict=True)
        trec = Recorder()
        tt = tcli.sequential_trainer(targs, MIXED, tmodel, None, tclients, {}, tcfg, CPU, trec)
        tt.run()
    return jt, jrec, tt, trec


def close(got, want_tree, what, lr, atol_lr=1 / 50):
    want = vilt_from_flax(jax.tree_util.tree_map(np.asarray, want_tree))
    assert set(got) == set(want), what
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-4, atol=lr * atol_lr,
                                   err_msg=f"{what}: {k}")


def test_mixed_round_step_losses_and_lrs_match_jax(mixed):
    _, jrec, tt, trec = mixed
    assert [t for t, _ in trec.steps] == [t for t, _ in jrec.steps] == \
        ["nlvr2"] * 2 + ["snli-ve"] * 2 + ["vcr", "vqa"]
    for (task, got), (_, want) in zip(trec.steps, jrec.steps):
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4, err_msg=f"{task}: {k}")


def test_mixed_round_parameters_and_personal_stores_match_jax(mixed):
    jt, _, tt, _ = mixed
    lr = max(TASK_CONFIGS[k].lr for k in MIXED)
    close(tt.server_params, jt.server_params, "server", lr, 1 / 20)
    mc_bias = "task_vcr.clf_fc0.bias"  # two updates in VCR's one step
    for key in MIXED:
        got = dict(tt.personal[key])
        assert any(k.startswith(f"task_{key}.") for k in got)
        if key == "vcr":
            np.testing.assert_allclose(got.pop(mc_bias).numpy(),
                                       np.asarray(jt.personal[key]["task_vcr"]["clf_fc0"]["bias"]),
                                       rtol=0, atol=2 * 2 * lr)
            want = {**jt.personal[key], "task_vcr": {**jt.personal[key]["task_vcr"], "clf_fc0": {
                "kernel": jt.personal[key]["task_vcr"]["clf_fc0"]["kernel"]}}}
        else:
            want = jt.personal[key]
        close(got, want, f"{key} personal", lr, 1 / 20)


def test_mixed_round_scores_match_jax(mixed):
    jt, _, tt, _ = mixed
    assert len(tt.history) == len(jt.history) == 1
    for key in MIXED:
        assert len(tt.history[0]["scores"][key]) == 3
        np.testing.assert_allclose(tt.history[0]["scores"][key], jt.history[0]["scores"][key],
                                   rtol=0, atol=1e-9)


def test_each_task_trains_on_its_own_optimizer_and_horizon(mixed):
    """The CLI's overrides reach each client: lr, weight decay, eps and
    warmup from the task config, and the schedule's horizon from its epochs
    (the steps' lr above is the schedule's value)."""
    _, _, tt, trec = mixed
    for c in tt.clients:
        spec = TASK_CONFIGS[c.task_key]
        assert (c.opt_cfg.lr, c.opt_cfg.weight_decay, c.opt_cfg.adam_eps,
                c.opt_cfg.warmup_ratio) == (spec.lr, spec.weight_decay, spec.adam_epsilon,
                                            spec.warmup_ratio)
    assert {c.task_key: c.opt_cfg.lr for c in tt.clients}["snli-ve"] == 5e-5
    opt, epochs = tcli.task_overrides(MIXED + ("vizwiz",))
    assert set(opt) == set(epochs) == set(MIXED) and epochs["snli-ve"] == 5
    # SNLI-VE: 2 steps per epoch x its 5 epochs (not --num_epochs' 10) = a
    # horizon of 10, warm-up 1; a DAT step reports its second update's lr,
    # counts 1 and 3: lr·(10 - 1)/(10 - 1) and lr·(10 - 3)/(10 - 1)
    snli = [m["lr"] for t, m in trec.steps if t == "snli-ve"]
    np.testing.assert_allclose(snli, [5e-5, 5e-5 * 7 / 9], rtol=1e-6)


# -- SPMD: two SNLI-VE clients of one head over 2 gloo ranks ------------------
SPMD_OPT = dict(lr=TASK_CONFIGS["snli-ve"].lr, weight_decay=TASK_CONFIGS["snli-ve"].weight_decay,
                adam_eps=TASK_CONFIGS["snli-ve"].adam_epsilon,
                warmup_ratio=TASK_CONFIGS["snli-ve"].warmup_ratio)


@pytest.fixture(scope="module")
def spmd_roots(tmp_path_factory):
    roots = []
    for seed in (1, 2):
        path = tmp_path_factory.mktemp(f"snli{seed}")
        chip_smoke.write_classification_dataset(str(path), seed, {"snli-ve": (8, 5)}, SIZES)
        roots.append(path)
    return roots


@pytest.fixture(scope="module")
def spmd_runs(spmd_roots, tmp_path_factory):
    from feddat_tpu.data.classification_datasets import SnliVePipeline as JaxSnli
    from feddat_tpu.data.classification_datasets import load_snli_ve_examples as jax_load_snli
    from feddat_tpu.data.images import make_backend as jax_make_backend

    canvas, text_len = (64, 64), 16
    jtok = JaxTokenizer.from_vocab_file(VOCAB)
    jclients = []
    for i, r in enumerate(spmd_roots):
        d = str(r / "snli-ve")
        pipe = JaxSnli(jax_load_snli(d, "train"), jax_make_backend("flickr30k", "snli-ve", str(r)),
                       jtok, text_len, canvas, 4, seed=1, eval_examples=jax_load_snli(d, "dev"))
        pipe.task_key = f"client_{i}"
        jclients.append(pipe)
    head = {FED_HEAD_KEY: JaxHeadSpec(num_labels=3)}
    jmodel, params = smoke_weights(head, next(jclients[0].train_batches(0)))
    jcfg, tcfg = configs(["client_0", "client_1"], optimizer=OptimizerConfig(**SPMD_OPT),
                         num_epochs=TASK_CONFIGS["snli-ve"].num_epochs)
    jt = JaxSPMD(jmodel, params, jclients, jcfg, jax_make_mesh(num_clients=2, data_parallel=1),
                 make_forward=lambda m, k: jax_make_vilt_forward(m, k, loss="ce"),
                 metric="accuracy")
    jt.run(resume=False)

    tmp = tmp_path_factory.mktemp("spmd_cls")
    weights = str(tmp / "weights.pt")
    torch.save(vilt_from_flax(params), weights)
    port_cfg = tcli.build_model(smoke_args(tcli.build_parser(), spmd_roots[0], ["snli-ve"]),
                                PEFTMode.DAT, {FED_HEAD_KEY: TaskHeadSpec(num_labels=3)}, CPU)[1]
    clients = [dict(root=str(r), vocab=VOCAB, batch_size=4, seed=1, key=f"client_{i}",
                    canvas=canvas, text_len=text_len) for i, r in enumerate(spmd_roots)]
    case = dict(family="snli-ve", model_cfg=port_cfg, heads={FED_HEAD_KEY: TaskHeadSpec(3)},
                weights=weights, clients=clients, config=tcfg, mesh_shape=(2, 1),
                metric="accuracy")
    return jt, spawn(2, tmp, [("snli", case)])


def test_spmd_classification_round_matches_jax(spmd_runs):
    jt, ranks = spmd_runs
    stacked = jax.tree_util.tree_map(np.asarray, jt.client_state)
    assert sorted(r["snli"]["slot"] for r in ranks) == [0, 1]
    for r in ranks:
        want = jax.tree_util.tree_map(lambda x: x[r["snli"]["slot"]], stacked)
        close(r["snli"]["client_state"], want, f"slot {r['snli']['slot']}", SPMD_OPT["lr"])
    histories = [r["snli"]["history"] for r in ranks]
    assert histories[0] == histories[1]
    (je,), (te,) = jt.history, histories[0]
    for key in ("client_0", "client_1"):
        assert len(te["scores"][key]) == 3
        np.testing.assert_allclose(te["scores"][key], je["scores"][key], rtol=0, atol=1e-9)


# -- JAX's errors, word for word ------------------------------------------------
def _message(fn, error):
    with pytest.raises(error) as e:
        fn()
    return str(e.value)


def test_spmd_refuses_a_non_uniform_head_as_jax(root, tmp_path):
    argv = ["--encoder_name", "vilt", "--ordered_cl_tasks", "nlvr2,snli-ve", "--engine", "spmd",
            "--climb_data_dir", str(root), "--smoke", "--output_dir", str(tmp_path)]
    want = _message(lambda: jcli.main(argv + ["--mesh_data", "1"]), ValueError)
    got = _message(lambda: tcli.main(argv + ["--mesh_clients", "1", "--device", "cpu"]), ValueError)
    assert got == want and want.startswith("--engine spmd needs a uniform head shape")


def test_spmd_refuses_mixed_optimizer_configs_as_jax(root, tmp_path):
    """SNLI-VE beside a task of the same head and trainer whose config sets
    another lr: one step program cannot serve both."""
    kw = dict(task_key="torch_cls_snli_ve_b", task_name="x", data_dir="snli-ve/",
              images_source="flickr30k", splits=("train", "dev"), num_labels=3, lr=1e-4,
              trainer="snli_ve")
    jax_register_task(JaxTaskSpec(**kw), overwrite=True)
    register_task(TaskSpec(**kw), overwrite=True)
    argv = ["--encoder_name", "vilt", "--ordered_cl_tasks", "snli-ve,torch_cls_snli_ve_b",
            "--engine", "spmd", "--climb_data_dir", str(root), "--vocab_file", VOCAB, "--smoke",
            "--dtype", "float32", "--output_dir", str(tmp_path)]
    want = _message(lambda: jcli.main(argv + ["--mesh_data", "1"]), SystemExit)
    got = _message(lambda: tcli.main(argv + ["--mesh_clients", "1", "--device", "cpu"]), SystemExit)
    assert got == want and "different per-task optimizer configs" in want


def test_albef_with_a_vilt_family_task_raises_as_jax(root):
    argv = ["--encoder_name", "albef_no_distill", "--climb_data_dir", str(root), "--smoke"]
    want = _message(lambda: jcli.build_clients(jcli.build_parser().parse_args(argv), ["vcr"], None),
                    NotImplementedError)
    got = _message(lambda: tcli.build_clients(tcli.build_parser().parse_args(argv), ["vcr"], None),
                   NotImplementedError)
    assert got == want == ("task 'vcr' (vcr) is a ViLT-family task; the reference has no ALBEF "
                           "path for it either")
