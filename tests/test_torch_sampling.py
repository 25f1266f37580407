"""The port's sampler (tts_tpu_torch.ops.sampling) against the JAX package's:
the filtered distribution and greedy tokens must agree; sampled draws use a
torch.Generator and are held to the distribution, not to JAX's draws."""

import numpy as np
import pytest
import torch

pytest.importorskip("jax")  # the reference; absent where only the port runs

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from tts_tpu.ops import sampling as js  # noqa: E402
from tts_tpu_torch.ops import sampling as ts  # noqa: E402

torch.set_num_threads(1)

CONFIGS = [
    dict(temperature=1.0, top_k=0, top_p=1.0, repetition_penalty=1.0, use_top_p=False),
    dict(temperature=0.7, top_k=50, top_p=1.0, repetition_penalty=1.0, use_top_p=False),
    dict(temperature=1.3, top_k=0, top_p=0.9, repetition_penalty=1.0, use_top_p=True),
    dict(temperature=0.9, top_k=40, top_p=0.8, repetition_penalty=1.3, use_top_p=True),
]


def _state(last, count):
    return ({"last": jnp.asarray(last, jnp.int32), "count": jnp.asarray(count, jnp.int32)},
            {"last": torch.tensor(last, dtype=torch.int32),
             "count": torch.tensor(count, dtype=torch.int32)})


@pytest.mark.parametrize("cfg", CONFIGS, ids=["plain", "topk", "topp", "all"])
def test_filtered_probs_matches_jax(cfg):
    """Same penalty, temperature, top-k, softmax and 30-step bisection top-p:
    f32 rounding apart (exp, sums), so atol 1e-6 on probabilities."""
    rng = np.random.default_rng(len(str(cfg)))
    logits = (rng.standard_normal((3, 2000)) * 3).astype(np.float32)
    jstate, tstate = _state([5, -1, 17], [2, 0, 1])
    want = np.asarray(js.filtered_probs(jnp.asarray(logits), jstate, **cfg))
    got = ts.filtered_probs(torch.from_numpy(logits), tstate, **cfg).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
    np.testing.assert_array_equal(got > 0, want > 0)        # same support


def test_greedy_matches_jax():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((4, 157000)).astype(np.float32)
    jstate, tstate = _state([3, 3, -1, 9], [1, 4, 0, 2])
    want, wstate = js.sample_tokens(jax.random.PRNGKey(0), jnp.asarray(logits), jstate,
                                    do_sample=False)
    got, gstate = ts.sample_tokens(None, torch.from_numpy(logits), tstate, do_sample=False)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gstate["count"].numpy(), np.asarray(wstate["count"]))
    np.testing.assert_array_equal(gstate["last"].numpy(), np.asarray(wstate["last"]))


def test_sampled_draws_follow_filtered_probs():
    """Gumbel-max over log(probs): 40k draws of one 6-way distribution (after
    top-k 4) land within 0.015 of each probability and never outside the
    support; the same seed gives the same draws."""
    logits = torch.tensor([[2.0, 1.0, 0.5, 0.0, -1.0, -3.0]]).repeat(40000, 1)
    state = ts.init_state(40000)
    probs = ts.filtered_probs(logits[:1], ts.init_state(1), top_k=4, use_top_p=False)[0]
    draw = lambda seed: ts.sample_tokens(torch.Generator().manual_seed(seed), logits, state,
                                         top_k=4, use_top_p=False)[0]
    tokens = draw(0)
    freq = torch.bincount(tokens.long(), minlength=6).float() / len(tokens)
    assert (freq[4:] == 0).all()
    torch.testing.assert_close(freq, probs, atol=0.015, rtol=0)
    torch.testing.assert_close(draw(0), tokens, rtol=0, atol=0)
