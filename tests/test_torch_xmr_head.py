"""PyTorch port, the MSCM vocab-tree head: ``repro_torch.models.xmr_head``
against ``repro.models.xmr_head`` on the same head and hidden states.

The reference's four tests in the port (dense agreement, exactness at
beam = C, padding never wins, recall rising with the beam), plus: the tree
built by ``from_lm_head`` (with padding and an ``order``) equal to the
reference's within ``F32`` (rtol and atol 1e-5: the centroid mean sums in
another order); the cluster beam's ids, token ids and the greedy token equal
to the reference's; ties at the beam cut broken to the lowest cluster id, as
``lax.top_k`` breaks them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.xmr_head import VocabTreeHead as JHead
from repro.models.xmr_head import greedy_token as j_greedy
from repro_torch.convert import vocab_head_from_numpy
from repro_torch.models.xmr_head import VocabTreeHead, greedy_token

F32 = dict(rtol=1e-5, atol=1e-5)
D, VOCAB, B = 64, 1000, 16  # ragged: 1000 % 16 != 0


@pytest.fixture(scope="module")
def head():
    """The reference's fixture (clustered rankers), built in both packages."""
    key = jax.random.PRNGKey(0)
    k1, k2 = jax.random.split(key)
    c = (VOCAB + B - 1) // B
    centers = jax.random.normal(k1, (c, D))
    w = centers[:, None, :] + 0.3 * jax.random.normal(k2, (c, B, D))
    w = np.array(w.reshape(c * B, D)[:VOCAB].T / np.sqrt(D))
    return JHead.from_lm_head(jnp.asarray(w), B), VocabTreeHead.from_lm_head(
        torch.from_numpy(w), B), w


def hidden(seed, n):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (n, D)))


def test_from_lm_head_matches_reference(head):
    jt, tt, _ = head
    assert (tt.n_clusters, tt.branching, tt.n_vocab) == (jt.n_clusters, jt.branching, jt.n_vocab)
    np.testing.assert_array_equal(tt.chunks.numpy(), np.asarray(jt.chunks))
    np.testing.assert_allclose(tt.wc.numpy(), np.asarray(jt.wc), **F32)
    order = np.random.default_rng(0).permutation(VOCAB)
    w = np.asarray(head[2])
    jo = JHead.from_lm_head(jnp.asarray(w), B, order=order)
    to = VocabTreeHead.from_lm_head(torch.from_numpy(w), B, order=order)
    np.testing.assert_array_equal(to.chunks.numpy(), np.asarray(jo.chunks))
    carried = vocab_head_from_numpy(np.asarray(jt.wc), np.asarray(jt.chunks), jt.n_vocab,
                                    device="cpu")
    assert torch.equal(carried.chunks, tt.chunks) and carried.n_vocab == VOCAB


def test_full_logits_match_dense(head):
    jt, tt, w = head
    h = hidden(1, 4)
    got = tt.full_logits(torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, h @ w, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(jt.full_logits(jnp.asarray(h))), **F32)


def test_full_beam_exact(head):
    _, tt, w = head
    h = hidden(2, 8)
    want = (torch.from_numpy(h) @ torch.from_numpy(w)).argmax(1)
    got = greedy_token(tt, torch.from_numpy(h), beam=tt.n_clusters)
    assert torch.equal(got, want)


def test_padding_tokens_never_win(head):
    _, tt, _ = head
    h = torch.from_numpy(hidden(3, 16))
    scores, ids = tt.decode_logits(h, beam=tt.n_clusters)
    best = ids.gather(1, scores.argmax(1)[:, None])
    assert (best < VOCAB).all()
    assert torch.isinf(scores[ids >= VOCAB]).all()


def test_beam_recall_increases(head):
    _, tt, w = head
    h = torch.from_numpy(hidden(4, 64))
    want = (h @ torch.from_numpy(w)).argmax(1)
    agree = []
    for beam in (1, 4, 16, tt.n_clusters):
        agree.append(float((greedy_token(tt, h, beam=beam) == want).float().mean()))
    assert agree[-1] == 1.0
    assert agree[0] <= agree[-1]
    assert agree[1] > 0.8  # structured head => even small beams route well


@pytest.mark.parametrize("beam", [1, 4, 16, 63])
def test_decode_logits_and_greedy_match_reference(head, beam):
    jt, tt, _ = head
    h = hidden(5, 32)
    js, jids = jt.decode_logits(jnp.asarray(h), beam=beam)
    ts, tids = tt.decode_logits(torch.from_numpy(h), beam=beam)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    finite = np.isfinite(np.asarray(js))
    np.testing.assert_array_equal(np.isfinite(ts.numpy()), finite)
    np.testing.assert_allclose(ts.numpy()[finite], np.asarray(js)[finite], **F32)
    np.testing.assert_array_equal(greedy_token(tt, torch.from_numpy(h), beam=beam).numpy(),
                                  np.asarray(j_greedy(jt, jnp.asarray(h), beam=beam)))


@pytest.mark.parametrize("beam", [1, 2, 3])
def test_ties_at_the_beam_cut(beam):
    """Clusters with equal scores at the cut: both packages keep the lowest
    cluster ids (``lax.top_k``'s order), and so pick the same token."""
    rng = np.random.default_rng(7)
    d, b, c = 8, 4, 6
    w = rng.standard_normal((d, c * b)).astype(np.float32)
    w[:, 4:8] = w[:, 0:4]            # clusters 0 and 1 identical ...
    w[:, 12:16] = w[:, 0:4]          # ... and 3
    w[:, 20:24] = w[:, 8:12]         # clusters 2 and 5 identical
    h = rng.standard_normal((5, d)).astype(np.float32)
    jt = JHead.from_lm_head(jnp.asarray(w), b)
    tt = VocabTreeHead.from_lm_head(torch.from_numpy(w), b)
    _, jids = jt.decode_logits(jnp.asarray(h), beam=beam)
    _, tids = tt.decode_logits(torch.from_numpy(h), beam=beam)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(jids))
    np.testing.assert_array_equal(greedy_token(tt, torch.from_numpy(h), beam=beam).numpy(),
                                  np.asarray(j_greedy(jt, jnp.asarray(h), beam=beam)))
