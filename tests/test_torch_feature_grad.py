"""F11: the port's ``FeatureExtractor`` follows grad mode, as the JAX
package's stops no gradient. On ``test_tiny_vit`` at a tiny width (the
port's fused K1 branch), with the JAX extractor's weights carried across by
``convert.from_jax.vit_state_dict``, the gradient of the sum of the squared
tapped maps with respect to the images (``torch.autograd.grad``) against
``jax.grad`` of the JAX ``FeatureExtractor`` on the same numpy images, and
the same for ``extract_kqv``; f32 within 1e-5 * max|ref| (JAX under
``jax.default_matmul_precision("float32")``). A call on images that do not
require grad records nothing: the frozen paths cost what they did."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_extract_kqv import CASES, _extractors

F32 = jax.default_matmul_precision("float32")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _tiny(monkeypatch, rng):
    narrow, size, _, _ = CASES["test_tiny_vit"]
    jext, text = _extractors(monkeypatch, rng, "test_tiny_vit", narrow)
    return jext, text, rng.randn(2, *size, 3).astype(np.float32)


def _close(got, ref):
    np.testing.assert_allclose(got, ref, atol=1e-5 * np.abs(ref).max(), rtol=0)


def test_input_gradient_through_the_extractor_matches_jax(monkeypatch, rng):
    jext, text, images = _tiny(monkeypatch, rng)
    with F32:
        ref = jax.grad(lambda x: sum(jnp.sum(m**2) for m in jext(x)))(jnp.asarray(images))
    x = torch.from_numpy(images).requires_grad_()
    maps = text(x)
    assert len(maps) == 4
    (got,) = torch.autograd.grad(sum((m**2).sum() for m in maps), x)
    _close(got.numpy(), np.asarray(ref))


def test_input_gradient_through_extract_kqv_matches_jax(monkeypatch, rng):
    jext, text, images = _tiny(monkeypatch, rng)
    with F32:
        ref = jax.grad(lambda x: jnp.sum(jext.extract_kqv(x, "kqv") ** 2))(jnp.asarray(images))
    x = torch.from_numpy(images).requires_grad_()
    (got,) = torch.autograd.grad((text.extract_kqv(x, "kqv") ** 2).sum(), x)
    _close(got.numpy(), np.asarray(ref))


def test_a_call_on_images_without_grad_records_nothing(monkeypatch, rng):
    _, text, images = _tiny(monkeypatch, rng)
    assert torch.is_grad_enabled()
    x = torch.from_numpy(images)
    maps, clss = text.outputs(x)
    assert all(t.grad_fn is None and not t.requires_grad for t in maps + clss)
    assert text.features(x)[0].grad_fn is None and text.extract_kqv(x).grad_fn is None
