"""PyTorch port, beam search: canonical selection is bitwise the reference's.

The reference orders candidates with a two-key ``lax.sort`` (score desc, id
asc), under which -0.0 and +0.0 are equal. The port packs both keys into
one int64; these tests pin ids and score bits on ties, signed zeros and
masked ``NEG_INF`` columns, on identical inputs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import beam as jbeam
from repro_torch.core import beam as tbeam

TIE_VALUES = np.array([0.5, 0.25, -0.0, 0.0, 0.125, -0.5, 1e-30, -1e-30], np.float32)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _case(seed, n, b, B, values):
    rng = np.random.default_rng(seed)
    parent = np.stack([rng.choice(40, size=b, replace=False) for _ in range(n)]).astype(np.int32)
    scores = rng.choice(values, size=(n, b, B)).astype(np.float32)
    return parent, scores


@pytest.mark.parametrize("next_b", [1, 4, 15, 24])
@pytest.mark.parametrize("values", ["ties", "normal"])
def test_beam_select_bitwise(next_b, values):
    vals = TIE_VALUES if values == "ties" else np.random.default_rng(1).standard_normal(50)
    parent, scores = _case(next_b, n=6, b=3, B=8, values=vals.astype(np.float32))
    n_cols = int(parent.max()) * 8 + 3  # masks the children of the largest parent
    ij, sj = jbeam.beam_select(jnp.asarray(parent), jnp.asarray(scores), n_cols, next_b)
    it, st = tbeam.beam_select(torch.from_numpy(parent), torch.from_numpy(scores), n_cols, next_b)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))


def test_beam_select_masked_columns_survive_only_after_real_ones():
    """More slots than real children: the masked ones come last, as NEG_INF,
    in id order — the same ids as the reference."""
    parent = np.array([[5, 2]], np.int32)
    scores = np.zeros((1, 2, 4), np.float32)
    scores[0, 0] = [-0.0, 0.0, -0.0, 0.3]
    n_cols = 21  # children of 5 are 20..23: only 20 is real
    ij, sj = jbeam.beam_select(jnp.asarray(parent), jnp.asarray(scores), n_cols, 8)
    it, st = tbeam.beam_select(torch.from_numpy(parent), torch.from_numpy(scores), n_cols, 8)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))
    assert it.numpy()[0, -3:].tolist() == [21, 22, 23]


@pytest.mark.parametrize("k", [1, 5, 12])
def test_topk_canonical_bitwise(k):
    rng = np.random.default_rng(k)
    scores = rng.choice(TIE_VALUES, size=(5, 12)).astype(np.float32)
    scores[:, ::4] = np.float32(-1e30)  # masked candidates
    ids = np.stack([rng.permutation(1000)[:12] for _ in range(5)]).astype(np.int32)
    ij, sj = jbeam.topk_canonical(jnp.asarray(scores), jnp.asarray(ids), k)
    it, st = tbeam.topk_canonical(torch.from_numpy(scores), torch.from_numpy(ids), k)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(_bits(st.numpy()), _bits(sj))


@pytest.mark.parametrize("mode", ["prod", "logsum"])
def test_beam_step_saturated_logits(mode):
    """Saturated logits tie exactly: sigmoid gives 1.0 and log-sigmoid a zero
    in both frameworks (signed zeros are pinned by the beam_select cases
    above), so the ids must be equal."""
    parent = np.array([[0, 1], [3, 2]], np.int32)
    logits = np.array(
        [[[110.0, 120.0, 0.5, 150.0], [200.0, -3.0, 0.0, 130.0]],
         [[0.0, 0.0, 150.0, 125.0], [130.0, 2.0, 105.0, 0.0]]], np.float32)
    ps = np.zeros((2, 2), np.float32) if mode == "logsum" else np.ones((2, 2), np.float32)
    ij, sj = jbeam.beam_step(jnp.asarray(parent), jnp.asarray(ps), jnp.asarray(logits),
                             16, 6, mode=mode)
    it, st = tbeam.beam_step(torch.from_numpy(parent), torch.from_numpy(ps),
                             torch.from_numpy(logits), 16, 6, mode=mode)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=1e-5, atol=1e-6)


def test_beam_step_denormal_band():
    """For logits in about [90, 104) log-sigmoid is a denormal in torch and
    a flushed -0.0 in jax's CPU backend: the scores differ by < 1e-38, far
    inside the tolerance, and may reorder those near-ties — the gap rule
    holds the labels."""
    from tests.test_torch_tree import assert_same_ranking

    parent = np.array([[0, 1]], np.int32)
    logits = np.array([[[95.0, 0.2, 91.0, -1.0], [-2.0, 99.0, 0.3, 93.0]]], np.float32)
    ps = np.zeros((1, 2), np.float32)
    ij, sj = jbeam.beam_step(jnp.asarray(parent), jnp.asarray(ps), jnp.asarray(logits),
                             8, 8, mode="logsum")
    it, st = tbeam.beam_step(torch.from_numpy(parent), torch.from_numpy(ps),
                             torch.from_numpy(logits), 8, 8, mode="logsum")
    assert_same_ranking(st.numpy(), it.numpy(), np.asarray(sj), np.asarray(ij))
    np.testing.assert_array_equal(it.numpy()[0, 4:], np.asarray(ij)[0, 4:])


@pytest.mark.parametrize("mode", ["prod", "logsum"])
def test_combine_scores_match(mode):
    rng = np.random.default_rng(2)
    ps = rng.random((3, 4)).astype(np.float32)
    logits = (rng.standard_normal((3, 4, 8)) * 10).astype(np.float32)
    want = jbeam.combine_scores(jnp.asarray(ps), jnp.asarray(logits), mode)
    got = tbeam.combine_scores(torch.from_numpy(ps), torch.from_numpy(logits), mode)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        tbeam.combine_scores(torch.from_numpy(ps), torch.from_numpy(logits), "max")
