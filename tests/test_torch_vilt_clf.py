"""The port's single-modality ViLT classifiers (``models/vilt_clf.py``)
against the JAX package's on the CPU, in float32 at tiny widths, from the
same weights (JAX's init tree filled with numpy, carried over by
``utils/param_bridge.py::vilt_from_flax``): image classification on an empty
text stream, text classification and text multiple choice against the mean
image, each in two adapter modes, at ViLT's fp32 tolerance
(tests/test_torch_vilt.py's RTOL/ATOL); ``mean_image`` bitwise."""

import jax
import numpy as np
import pytest
import torch

import feddat_tpu.models.vilt_clf as jclf
import feddat_tpu_torch.models.vilt_clf as tclf
from feddat_tpu_torch.utils.param_bridge import vilt_from_flax

from conftest import TINY_VILT
from test_torch_remat import random_like_init
from test_torch_vilt import ATOL, RTOL, port_config

B, C, L = 3, 4, TINY_VILT.max_text_len
H, W = TINY_VILT.image_size


def inputs(seed=0):
    rng = np.random.RandomState(seed)
    ids = rng.randint(1, TINY_VILT.vocab_size, (B, C, L)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, :, 5:] = 0
    pixel_mask = np.ones((B, H, W), np.int32)
    pixel_mask[1, :, 16:] = 0
    images = rng.randn(5, H, W, 3).astype(np.float32)
    return dict(ids=ids, mask=mask, pixels=rng.randn(B, H, W, 3).astype(np.float32),
                pixel_mask=pixel_mask, mean=jclf.mean_image(images), images=images)


CASES = {
    # [CLS]/[SEP] ids inside the tiny vocabulary (BERT's 101/102 by default)
    "image": (lambda: jclf.ViltForImageClassification(TINY_VILT, num_labels=5, cls_token_id=2,
                                                      sep_token_id=3),
              lambda: tclf.ViltForImageClassification(port_config(TINY_VILT), num_labels=5,
                                                      cls_token_id=2, sep_token_id=3),
              lambda x: (x["pixels"], x["pixel_mask"])),
    "sequence": (lambda: jclf.ViltForSequenceClassification(TINY_VILT, num_labels=3),
                 lambda: tclf.ViltForSequenceClassification(port_config(TINY_VILT), num_labels=3),
                 lambda x: (x["ids"][:, 0], x["mask"][:, 0], x["mean"])),
    "multiple_choice": (lambda: jclf.ViltForMultipleChoice(TINY_VILT, num_choices=C),
                        lambda: tclf.ViltForMultipleChoice(port_config(TINY_VILT), num_choices=C),
                        lambda x: (x["ids"], x["mask"], x["mean"])),
}


@pytest.mark.parametrize("mode", ["none", "ensemble"])
@pytest.mark.parametrize("kind", list(CASES))
def test_classifier_matches_jax(kind, mode):
    make_jax, make_port, args = CASES[kind]
    x = inputs()
    jmodel = make_jax()
    abstract = jax.eval_shape(lambda: jmodel.init(jax.random.PRNGKey(0), *args(x),
                                                  adapter_mode="init_all"))["params"]
    params = random_like_init(abstract, 2)
    want = jax.jit(lambda p: jmodel.apply({"params": p}, *args(x), adapter_mode=mode))(params)
    model = make_port()
    model.load_state_dict(vilt_from_flax(params), strict=True)
    with torch.no_grad():
        got = model(*[torch.from_numpy(np.asarray(a)) for a in args(x)], adapter_mode=mode)
    assert tuple(got.shape) == np.shape(want)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_mean_image_is_jaxs():
    images = inputs()["images"]
    got = tclf.mean_image(images)
    assert got.dtype == np.float32 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, jclf.mean_image(images))
