"""The port's codecs (``repro_torch.compression``) against the JAX
package's on identical inputs, and ``CommParams.with_codec``.

* int8: ``values`` and ``scales`` BIT FOR BIT, with the same noise ``u``
  handed to both (the JAX side draws it from its key, the port is given
  it) and with ``u=None`` (round to nearest; ``jnp.round`` and
  ``torch.round`` both round half to even), chunks 64/128/256 and ragged
  widths. The JAX encode runs under jit, as the engines run it: XLA then
  turns the divide by 127 into a multiply by its f32 reciprocal, which
  the port copies;
* bf16 bit for bit;
* topk: ``_k`` for the float-ceil cases, and the DECODED buffer bit for
  bit on tie-free inputs. The index record itself may differ under ties
  of |x|: ``jax.lax.top_k`` and ``torch.topk`` order ties differently;
* ``feedback_encode`` / ``transmit`` residuals of every codec bit for bit;
* the registry and ``as_codec`` / ``active``.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro import compression as jcomp  # noqa: E402
from repro.core.comm_model import CommParams as JCommParams  # noqa: E402
from repro_torch import compression  # noqa: E402
from repro_torch.core.comm_model import CommParams  # noqa: E402


def _x(n, width, seed):
    return np.random.default_rng(seed).normal(
        size=(n, width)).astype(np.float32) * 1e-2


@pytest.mark.parametrize("chunk", [64, 128, 256])
@pytest.mark.parametrize("width", [1, 129, 700, 1024])
@pytest.mark.parametrize("stochastic", [True, False])
def test_int8_bitwise_with_same_noise(chunk, width, stochastic):
    x = _x(5, width, seed=chunk + width)
    jc, tc = jcomp.Int8Codec(chunk=chunk), compression.Int8Codec(chunk=chunk)
    key = jax.random.PRNGKey(width) if stochastic else None
    jenc = jax.jit(lambda a: jc.encode(a, key=key))(jnp.asarray(x))
    u = None
    if stochastic:       # the noise the JAX encode draws (codecs.py:108)
        nc = tc.padded(width) // chunk
        u = torch.from_numpy(np.array(jax.random.uniform(
            key, (5, nc, chunk)))).reshape(5, -1)
    tenc = tc.encode(torch.from_numpy(x), u=u)
    assert tenc.values.dtype == torch.int8
    np.testing.assert_array_equal(tenc.values.numpy(),
                                  np.asarray(jenc.values))
    np.testing.assert_array_equal(tenc.scales.numpy(),
                                  np.asarray(jenc.scales))
    np.testing.assert_array_equal(
        tc.decode(tenc, (5, width)).numpy(),
        np.asarray(jc.decode(jenc, (5, width))))


def test_int8_rounds_half_to_even_and_keeps_dead_chunks():
    tc = compression.Int8Codec(chunk=4)
    # absmax 127 -> scale 1 (up to the reciprocal's rounding): y = x
    x = torch.tensor([[0.5, 1.5, -2.5, 127.0, 0.0, 0.0, 0.0, 0.0]])
    enc = tc.encode(x)
    assert enc.values[0, :4].tolist() == [0, 2, -2, 127]
    assert enc.values[0, 4:].tolist() == [0, 0, 0, 0]
    assert float(enc.scales[0, 1]) == pytest.approx(1e-12)


def test_bf16_bitwise():
    x = _x(4, 333, seed=1) * 1e3
    jenc = jcomp.BF16Codec().encode(jnp.asarray(x))
    tenc = compression.BF16Codec().encode(torch.from_numpy(x))
    np.testing.assert_array_equal(tenc.to(torch.float32).numpy(),
                                  np.asarray(jenc.astype(jnp.float32)))


@pytest.mark.parametrize("n,density", [(1, 0.05), (19, 0.05), (20, 0.05),
                                       (21, 0.05), (100, 0.1), (7, 0.3),
                                       (1000, 0.001), (3, 1.0)])
def test_topk_k_matches_jax(n, density):
    assert (compression.TopKCodec(density=density)._k(n)
            == jcomp.TopKCodec(density=density)._k(n))


@pytest.mark.parametrize("width,density", [(1, 0.05), (40, 0.05),
                                           (997, 0.05), (300, 0.2)])
def test_topk_decoded_bitwise_on_tie_free_input(width, density):
    x = _x(6, width, seed=width)
    assert all(len(set(np.abs(r))) == width for r in x)   # no ties
    jc, tc = jcomp.TopKCodec(density), compression.TopKCodec(density)
    want = jc.roundtrip(jnp.asarray(x))
    got = tc.roundtrip(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("name", ["bf16", "int8", "topk", "none"])
def test_feedback_encode_and_transmit_match_jax(name):
    delta, res = _x(5, 700, seed=2), _x(5, 700, seed=3) * 0.1
    jc, tc = jcomp.get(name), compression.get(name)
    residual = res if tc.stateful else None
    jfn = jax.jit(lambda d, r: jcomp.transmit(jc, d, r))
    jhat, jres = jfn(jnp.asarray(delta),
                     None if residual is None else jnp.asarray(residual))
    that, tres = compression.transmit(
        tc, torch.from_numpy(delta),
        None if residual is None else torch.from_numpy(residual))
    np.testing.assert_array_equal(that.numpy(), np.asarray(jhat))
    if tc.stateful:
        np.testing.assert_array_equal(tres.numpy(), np.asarray(jres))
    else:
        assert tres is None and jres is None
    enc, shape, new_res = compression.feedback_encode(
        tc, torch.from_numpy(delta),
        None if residual is None else torch.from_numpy(residual))
    assert shape == (5, 700)
    assert (new_res is None) == (not tc.stateful)


def test_registry_and_cost_model():
    assert compression.names() == jcomp.names()
    for name in compression.names():
        assert (compression.get(name).bits_per_param()
                == jcomp.get(name).bits_per_param())
        assert (compression.get(name).stateful
                == jcomp.get(name).stateful)
    assert compression.active(None) is None
    assert compression.active("none") is None
    assert compression.active("int8") is compression.get("int8")
    assert compression.as_codec(None).name == "none"
    with pytest.raises(ValueError, match="unknown codec 'zip'"):
        compression.get("zip")
    jp = JCommParams(model_bytes=4e6, server_bw=1e8, device_bw=1e9)
    tp = CommParams(model_bytes=4e6, server_bw=1e8, device_bw=1e9)
    for name in compression.names():
        assert (tp.with_codec(name).wire_bytes
                == jp.with_codec(name).wire_bytes)
