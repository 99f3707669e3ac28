"""The port's ViLT-BERT (``models/viltbert.py``) against the JAX package's on
the CPU, in float32 at tiny widths, from the same weights (JAX's init tree
filled with numpy, carried over by ``utils/param_bridge.py::
viltbert_from_flax``).

With dropout off, the five methods (``forward_single_image``,
``forward_multi_images``, ``forward_multi_choice``, ``encode_single_image``,
``init_all``) give JAX's pooled features and logits at ViLT's fp32 tolerance
(tests/test_torch_vilt.py's RTOL/ATOL).  The text BERT is frozen as in JAX:
its gradient is exactly zero, a standard DAT step with its dropout live
leaves it bitwise unchanged, and after two FULL-mode steps it equals JAX's
(both Partitioners keep ``text_bert`` out of every trainable set).  ``--bert_model_path``'s conversion and merge
give JAX's tree bit for bit.  With the BERT's dropout live, the standard DAT
step's loss means over 16 generator seeds are within 4 pooled standard
errors of JAX's over 16 keys (the masks cannot match bit for bit)."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

import feddat_tpu.utils.checkpoint_convert as jcc
import feddat_tpu_torch.cli as tcli
from feddat_tpu.configs.core import AdapterSpec
from feddat_tpu.configs.core import OptimizerConfig as JaxOptimizerConfig
from feddat_tpu.configs.core import PEFTMode as JaxPEFTMode
from feddat_tpu.models.vilt import TaskHeadSpec as JaxHeadSpec
from feddat_tpu.models.viltbert import ViltBertContinualLearner as JaxViltBert
from feddat_tpu.train import dat as jdat
from feddat_tpu.train.forwards import make_vilt_forward as jax_make_vilt_forward
from feddat_tpu_torch.configs.core import OptimizerConfig, PEFTMode
from feddat_tpu_torch.models.vilt import TaskHeadSpec
from feddat_tpu_torch.models.viltbert import ViltBertContinualLearner
from feddat_tpu_torch.train import dat as tdat
from feddat_tpu_torch.train.forwards import call_method, make_vilt_forward, to_device
from feddat_tpu_torch.utils.param_bridge import viltbert_from_flax

from conftest import TINY_VILT, tiny_batch
from test_torch_checkpoint_convert import _bert_state_dict
from test_torch_remat import random_like_init
from test_torch_vilt import ATOL, HEADS, RTOL, port_config, to_torch

CPU = torch.device("cpu")
OPT = dict(lr=1e-2, weight_decay=1e-2, warmup_ratio=0.0)


FULL_CFG = dataclasses.replace(TINY_VILT, adapter=AdapterSpec())  # FULL mode's: no adapters


def jax_model(cfg=TINY_VILT):
    return JaxViltBert(cfg, {k: JaxHeadSpec(**v) for k, v in HEADS.items()})


def batches(seed=3):
    """Single-image, two-image and three-choice batches with padded text."""
    rng = np.random.RandomState(seed)
    single = tiny_batch(rng, 3)
    single["attention_mask"][0, 5:] = 0
    nlvr = dict(tiny_batch(rng, 2), pixel_values=rng.randn(2, 2, 32, 32, 3).astype(np.float32),
                labels=np.array([0, 1], np.int64))
    ids = rng.randint(1, 100, (2, 3, TINY_VILT.max_text_len)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 2, 4:] = 0
    vcr = dict(tiny_batch(rng, 2), input_ids=ids, attention_mask=mask,
               labels=np.array([2, 0], np.int64))
    return {"coco": single, "nlvr": nlvr, "vcr": vcr}


def init_weights(cfg):
    batch = tiny_batch(np.random.RandomState(0), 2)
    abstract = jax.eval_shape(lambda: jax_model(cfg).init(
        jax.random.PRNGKey(0), batch, method=JaxViltBert.init_all))["params"]
    return random_like_init(abstract, 1)


@pytest.fixture(scope="module")
def weights():
    return init_weights(TINY_VILT)


def port(params, attn_impl="auto", cfg=TINY_VILT):
    model = ViltBertContinualLearner(port_config(cfg),
                                     {k: TaskHeadSpec(**v) for k, v in HEADS.items()},
                                     attn_impl=attn_impl)
    model.load_state_dict(viltbert_from_flax(params), strict=True)
    return model.eval()


def state(model):
    return {k: v.detach() for k, v in model.state_dict().items()}


def test_the_bridge_maps_every_leaf_and_the_vilt_half_has_no_word_table(weights):
    sd = viltbert_from_flax(weights)
    model = port(weights)
    assert set(sd) == set(model.state_dict())
    assert "vilt.text_embeddings.word_embeddings.weight" not in sd
    assert "text_bert.encoder.text_layers.1.attention.query.dense.weight" in sd
    assert not any("fusion_layers" in k for k in sd)
    assert model.text_bert.embeddings.position_embeddings.weight.shape[0] == 512


METHODS = [
    ("forward_single_image", "coco", "ensemble", "auto"),
    ("forward_single_image", "coco", "ensemble", "layer"),
    ("forward_multi_images", "nlvr", "ensemble", "auto"),
    ("forward_multi_choice", "vcr", "adapter_0", "auto"),
    ("encode_single_image", "coco", "adapter_1", "auto"),
    ("init_all", "vcr", "init_all", "auto"),
]


@pytest.mark.parametrize("method,task,mode,attn_impl", METHODS,
                         ids=[f"{m}-{i}" for m, _, _, i in METHODS])
def test_methods_match_jax(weights, method, task, mode, attn_impl):
    """Dropout off.  The port's "layer" route (its plain whole-layer version
    on the CPU) with the BERT's states as ``inputs_embeds``, against JAX's
    composable route."""
    batch = batches()[task]
    jm = jax_model()
    if method == "init_all":
        want = jm.apply({"params": weights}, batch, method=JaxViltBert.init_all)
        with torch.no_grad():
            got = port(weights, attn_impl).init_all(to_torch(batch))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)
        return
    want = jm.apply({"params": weights}, task, batch, adapter_mode=mode, deterministic=True,
                    method=getattr(JaxViltBert, method))
    with torch.no_grad():
        got = getattr(port(weights, attn_impl), method)(task, to_torch(batch), adapter_mode=mode)
    want, got = (want, got) if method != "encode_single_image" else ((want,), (got,))
    for g, w in zip(got, want):
        assert tuple(g.shape) == np.shape(w)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_text_bert_gets_an_exactly_zero_gradient(weights):
    """FULL mode's view: every parameter a leaf of the loss; the text BERT's
    gradient is exactly zero (``no_grad``, JAX's ``stop_gradient``), the ViLT
    half's is not."""
    model = port(weights)
    params = {k: v.clone().requires_grad_() for k, v in state(model).items()}
    batch = to_device(batches()["nlvr"], CPU)
    loss, _ = make_vilt_forward(model, "nlvr", loss="ce")(params, batch, "ensemble",
                                                          torch.Generator().manual_seed(0))
    text = [v for k, v in params.items() if k.startswith("text_bert.")]
    rest = [params[k] for k in ("vilt.pooler.weight", "vilt.layers.0.mlp.output.weight")]
    grads = torch.autograd.grad(loss, text + rest, allow_unused=True, materialize_grads=True)
    assert len(text) > 20 and all(torch.count_nonzero(g) == 0 for g in grads[:len(text)])
    assert all(torch.count_nonzero(g) > 0 for g in grads[len(text):])


def test_a_dat_step_with_live_dropout_leaves_the_text_bert_bitwise_unchanged(weights):
    model = port(weights)
    sd = state(model)
    part = tdat.Partitioner(sd, "vcr", PEFTMode.DAT)
    opt = OptimizerConfig(**OPT)
    step = tdat.make_dat_train_step(make_vilt_forward(model, "vcr", loss="ce"), part, opt, 100)
    st = tdat.init_train_state(sd, part, opt, torch.Generator().manual_seed(0))
    batch = to_device(batches()["vcr"], CPU)
    for _ in range(2):
        st, m = step(st, batch)
    text = [k for k in sd if k.startswith("text_bert.")]
    assert text and all(torch.equal(st.params[k], sd[k]) for k in text)
    assert not torch.equal(st.params["vilt.layers.0.adapter.adapter_0_up.bias"],
                           sd["vilt.layers.0.adapter.adapter_0_up.bias"])


def test_full_mode_leaves_the_text_bert_as_jaxs_optimizer_does():
    """Two FULL-mode steps: the text BERT's values equal JAX's, which keeps
    every ``text_bert`` name out of the trainable set (its Partitioner, as
    the port's), so no weight decay reaches them either: bitwise the initial
    values; the ViLT half's weights moved (the BERT's dropout is live)."""
    batch = batches()["coco"]
    weights = init_weights(FULL_CFG)
    jm = jax_model(FULL_CFG)
    jopt = JaxOptimizerConfig(**OPT)
    jpart = jdat.Partitioner(weights, "coco", JaxPEFTMode.FULL)
    jstep = jdat.make_plain_train_step(jax_make_vilt_forward(jm, "coco"), jpart, jopt, 100, "none",
                                       donate=False)
    js = jdat.init_train_state(weights, jpart, jopt, jax.random.PRNGKey(0))
    model = port(weights, cfg=FULL_CFG)
    sd = state(model)
    opt = OptimizerConfig(**OPT)
    part = tdat.Partitioner(sd, "coco", PEFTMode.FULL)
    step = tdat.make_plain_train_step(make_vilt_forward(model, "coco"), part, opt, 100, "none")
    ts = tdat.init_train_state(sd, part, opt, torch.Generator().manual_seed(0))
    for _ in range(2):
        js, _ = jstep(js, batch)
        ts, _ = step(ts, to_device(batch, CPU))
    want = viltbert_from_flax(jax.tree_util.tree_map(np.asarray, js.params))
    text = [k for k in sd if k.startswith("text_bert.")]
    assert text and all(torch.equal(ts.params[k], want[k]) for k in text)
    assert all(torch.equal(ts.params[k], sd[k]) for k in text)
    # the ViLT half trains (its values differ from JAX's: the BERT's dropout
    # masks differ)
    for k in ("vilt.pooler.weight", "vilt.layers.1.mlp.intermediate.weight"):
        assert not torch.equal(ts.params[k], sd[k])


def test_bert_model_path_converts_and_merges_as_jax(weights, tmp_path):
    sd = _bert_state_dict(np.random.RandomState(4), TINY_VILT.num_layers, 99)
    sd["embeddings.position_embeddings.weight"] = torch.randn(
        512, TINY_VILT.hidden_size, generator=torch.Generator().manual_seed(5))
    path = tmp_path / "bert.bin"
    torch.save(sd, path)
    args = tcli.build_parser().parse_args(["--encoder_name", "viltbert", "--bert_model_path",
                                           str(path)])
    got = tcli._merge_text_bert(args, viltbert_from_flax(weights), port_config(TINY_VILT))
    tree = jcc.convert_bert_to_xbert(sd, num_layers=TINY_VILT.num_layers,
                                     fusion_layer=TINY_VILT.num_layers)
    want = viltbert_from_flax(jax.tree_util.tree_map(
        np.asarray, jcc.merge_pretrained(weights, {"text_bert": tree})))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert torch.equal(got["text_bert.embeddings.word_embeddings.weight"],
                       sd["embeddings.word_embeddings.weight"])


def test_live_dropout_loss_means_match_jax_by_distribution(weights):
    """The standard DAT step (three stochastic forwards) with the text BERT's
    dropout 0.1 live: two steps' losses over 16 seeds on each side, every
    mean within 4 pooled standard errors of the other's."""
    batch = batches()["coco"]
    n = 16
    jm = jax_model()
    jopt = JaxOptimizerConfig(**OPT)
    jpart = jdat.Partitioner(weights, "coco", JaxPEFTMode.DAT)
    jstep = jdat.make_dat_train_step(jax_make_vilt_forward(jm, "coco"), jpart, jopt, 100,
                                     donate=False)
    model = port(weights)
    sd = state(model)
    opt = OptimizerConfig(**OPT)
    part = tdat.Partitioner(sd, "coco", PEFTMode.DAT)
    step = tdat.make_dat_train_step(make_vilt_forward(model, "coco"), part, opt, 100)
    tbatch = to_device(batch, CPU)
    rows = {"jax": [], "port": []}
    for seed in range(n):
        js = jdat.init_train_state(weights, jpart, jopt, jax.random.PRNGKey(100 + seed))
        ts = tdat.init_train_state(sd, part, opt, torch.Generator().manual_seed(100 + seed))
        row_j, row_t = [], []
        for _ in range(2):
            js, jmet = jstep(js, batch)
            ts, tmet = step(ts, tbatch)
            row_j += [float(jmet["loss"]), float(jmet["loss_shared"])]
            row_t += [float(tmet["loss"]), float(tmet["loss_shared"])]
        rows["jax"].append(row_j)
        rows["port"].append(row_t)
    j, t = np.array(rows["jax"]), np.array(rows["port"])
    assert j.std(axis=0).min() > 1e-6 and t.std(axis=0).min() > 1e-6
    se = np.sqrt((j.var(axis=0) + t.var(axis=0)) / n)
    diff = np.abs(j.mean(axis=0) - t.mean(axis=0))
    assert (diff < 4 * se + 1e-7).all(), (diff, 4 * se, j.mean(axis=0), t.mean(axis=0))


def test_the_bert_draws_its_masks_from_the_calls_generator(weights):
    """Live dropout with a generator: two calls from equal seeds are bitwise
    equal and another seed differs; deterministic calls are equal to each
    other."""
    model = port(weights)
    sd = state(model)
    batch = to_torch(batches()["coco"])

    def pooled(seed):
        gen = None if seed is None else torch.Generator().manual_seed(seed)
        with torch.no_grad():
            return call_method(model, sd, "encode_single_image", "coco", batch,
                               deterministic=seed is None, rng=gen)

    assert torch.equal(pooled(1), pooled(1)) and not torch.equal(pooled(1), pooled(2))
    assert torch.equal(pooled(None), pooled(None)) and not torch.equal(pooled(None), pooled(1))
