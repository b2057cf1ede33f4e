"""The port on the card against the JAX package at the main path's full
configuration: CNN-FEMNIST at its published widths (246,590 params),
``pseudo_femnist_federated(100, num_classes=62, seed=0)``, the default
``FLConfig`` (E=20, batch 10) at lr 0.05 with 100 participants, three
rounds of: fedp2p, gossip_async (one random matching a round: the
fed_mix_matching kernel) and fedp2p with the int8 wire on
mix_path="dense" (the fed_mix_q kernel). Both packages get the same
initial weights and the same draws (the JAX key tree, handed to the port
as ``RoundDraws``, the matching index and the int8 rounding noise
included). And Hymba-1.5B's serving path at full width: prefill and four
greedy decode steps against the JAX model on the card
(``test_hymba_full_width_tracks_jax_on_card``).

It needs a card and JAX with a GPU backend: the JAX reference runs on the
card too, at "highest" matmul precision (full f32, no TF32); on a CPU one
of its rounds takes tens of minutes. Run it on the card with

    python -m pytest -q -s -m cuda tests/test_torch_cuda_reference.py

Tolerance: per round, train_loss within 5 % and accuracies within 0.02.
Each round is 200 SGD steps at a learning rate that overshoots from the
first steps at these widths, so the two packages' f32 summation orders
drift apart far more than in the short parity runs of
``test_torch_engine.py`` (rtol 1e-4). gossip_async runs at 100
participants (``participation=100``), the width of the fedp2p runs: at
10 participants (the Table-1 participation) local training on the card
misses these bounds in the first round, before any mix has run (round 1
train_loss 1.434 against JAX's 1.336 with cuDNN's algorithms pinned).
With cuDNN's default algorithms the port's own round 1 there moved by up
to 14 % between runs, so a change of summation order alone moves a
10-participant round by more than the bound (PERF.md, open questions).
The values are printed as one JSON line.
"""
import json
import os

# JAX must not take most of the card's memory before PyTorch runs
os.environ.setdefault("XLA_PYTHON_CLIENT_PREALLOCATE", "false")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

pytestmark = pytest.mark.cuda
jax = pytest.importorskip("jax")

ROUNDS = 3


@pytest.mark.parametrize("algo,codec,mix_path", [
    ("fedp2p", None, "auto"), ("gossip_async", None, "auto"),
    ("fedp2p", "int8", "dense")])
def test_full_configuration_tracks_jax_on_card(algo, codec, mix_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    try:
        gpu = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs JAX with a GPU backend for the full-size "
                    "reference")
    from repro import protocols as jprotocols
    from repro.config import FLConfig as JFLConfig
    from repro.configs.paper_models import CNN_FEMNIST as J_CNN
    from repro.core.simulator import Simulator as JSimulator
    from repro.data.federated import pseudo_femnist_federated
    from repro_torch.config import FLConfig
    from repro_torch.configs.paper_models import CNN_FEMNIST
    from repro_torch.convert import params_from_jax
    from repro_torch.core.simulator import Simulator
    from test_torch_engine import run_draws

    data = pseudo_femnist_federated(100, num_classes=62, seed=0)
    kw = dict(lr=0.05, mix_path=mix_path, participation=100)
    jfl = JFLConfig(**kw)
    sim = Simulator(CNN_FEMNIST, data, FLConfig(**kw), device="cuda")
    engine = sim.engine(algo, codec=codec)
    with jax.default_device(gpu), jax.default_matmul_precision("highest"):
        jsim = JSimulator(J_CNN, data, jfl)
        hist = jsim.run(rounds=ROUNDS, algorithm=algo, seed=0, codec=codec)
        jparams = jax.tree.map(np.asarray, jsim.init_params(0))
        int8 = None if codec is None else (
            engine.codec, sum(a.size for a in jax.tree.leaves(jparams)))
        draws = run_draws(jprotocols.get(algo), jfl, 0, ROUNDS,
                          data.y.shape[1], int8)
    _, m = engine.run_rounds(params_from_jax(jparams, "cuda"), None, ROUNDS,
                             draws=draws)
    got = {k: v.cpu().tolist() for k, v in m.items()}
    want = {"train_loss": hist.train_loss, "acc": hist.acc,
            "acc_client_mean": hist.acc_client_mean}
    print(json.dumps({"algorithm": algo, "codec": codec,
                      "mix_path": mix_path, "jax": want,
                      "port_on_card": got}))
    np.testing.assert_allclose(got["train_loss"], want["train_loss"],
                               rtol=0.05, err_msg="train_loss")
    for k in ("acc", "acc_client_mean"):
        np.testing.assert_allclose(got[k], want[k], atol=0.02, err_msg=k)


HYMBA_PROMPT, HYMBA_BATCH, HYMBA_STEPS = 384, 2, 4
# Hymba-1.5B at full width, f32 on both sides: logits within rtol 1e-3 and
# 1e-3 of their scale. 32 layers of f32 products summed in other orders
# (cuBLAS and the port's kernels against XLA's GPU kernels) drift by a few
# 1e-5 of the logits' scale; 1e-3 leaves room for that and none for a
# wrong mask, window or state.
HYMBA_RTOL = 1e-3


def test_hymba_full_width_tracks_jax_on_card():
    """JAX Hymba-1.5B on the card ("highest" matmul precision, no
    preallocation) against the port on the card, one set of weights
    carried across (``lm_params_from_jax``): prefill logits at a 384-token
    prompt (512 positions with the 128 meta tokens), then 4 greedy decode
    steps, both sides fed JAX's greedy tokens (so a near tie cannot fork
    the two runs). The port's greedy token must equal JAX's wherever
    JAX's top two logits are further apart than the tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    try:
        gpu = jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("needs JAX with a GPU backend for the full-size "
                    "reference")
    import jax.numpy as jnp
    from repro.configs import get_config as jget_config
    from repro.launch.steps import build_decode_step as jdecode_step
    from repro.launch.steps import build_prefill_step as jprefill_step
    from repro.models.model import build_model as jbuild_model
    from repro_torch.configs import get_config
    from repro_torch.convert import lm_params_from_jax
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models.model import build_model

    cfg = get_config("hymba-1.5b")
    m = cfg.num_meta_tokens
    buf = max(cfg.sliding_window + m, HYMBA_PROMPT + m)
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (HYMBA_BATCH, HYMBA_PROMPT)).astype(np.int32)
    jmodel = jbuild_model(jget_config("hymba-1.5b"))
    with jax.default_device(gpu), jax.default_matmul_precision("highest"):
        jparams = jmodel.init(jax.random.PRNGKey(0))
        jprefill = jax.jit(jprefill_step(jmodel))
        jdecode = jax.jit(jdecode_step(jmodel))
        logits, jcache = jprefill(jparams, {"tokens": jnp.asarray(prompts)},
                                  jmodel.make_cache(HYMBA_BATCH, buf))
        want, toks = [np.asarray(logits[:, -1])], []
        for _ in range(HYMBA_STEPS):
            toks.append(np.argmax(want[-1], axis=-1).astype(np.int32))
            logits, jcache = jdecode(jparams, jcache,
                                     {"token": jnp.asarray(toks[-1])[:, None]})
            want.append(np.asarray(logits))
        host = jax.tree.map(np.asarray, jparams)
    del jparams, jcache, logits
    params = lm_params_from_jax(host, "cuda")
    del host
    model = build_model(cfg)
    logits, cache = build_prefill_step(model)(
        params, {"tokens": torch.from_numpy(prompts).cuda()},
        model.make_cache(HYMBA_BATCH, buf, device="cuda"))
    got = [logits[:, -1].cpu().numpy()]
    decode = build_decode_step(model)
    for tok in toks:
        logits, cache = decode(params, cache,
                               {"token": torch.from_numpy(tok).cuda()[:, None]})
        got.append(logits.cpu().numpy())
    got, want = np.stack(got), np.stack(want)
    scale = float(np.abs(want).max())
    err = np.abs(got - want)
    top2 = np.sort(want, axis=-1)[..., -2:]
    clear = (top2[..., 1] - top2[..., 0]) > 2 * HYMBA_RTOL * scale
    print(json.dumps({
        "model": "hymba-1.5b", "batch": HYMBA_BATCH,
        "prompt": HYMBA_PROMPT, "decode_steps": HYMBA_STEPS,
        "max_abs_err_logits": float(err.max()), "logits_scale": scale,
        "max_rel_err_logits": float((err / (np.abs(want) + 1e-6)).max()),
        "greedy_jax": np.argmax(want, -1).tolist(),
        "greedy_port": np.argmax(got, -1).tolist(),
        "clear_top1": clear.tolist()}))
    np.testing.assert_allclose(got, want, rtol=HYMBA_RTOL,
                               atol=HYMBA_RTOL * scale)
    assert np.array_equal(np.argmax(got, -1)[clear],
                          np.argmax(want, -1)[clear])
