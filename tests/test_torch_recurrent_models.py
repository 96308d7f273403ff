"""The port's recurrent families against the reference at reduced size:
rwkv6-3b (RWKV6, ``family="ssm"``: no KV cache, state planes only) and
hymba-1.5b (``family="hybrid"``: attention and a Mamba branch side by side),
plain, ``+w4a8`` and on a ring KV cache (``+ring``, ``+ring+w4a8``).

float32, ``decode_impl="kernel"`` (the port runs its kernels' plain versions
on the CPU, the reference its Pallas kernels in interpret mode), the
reference's weights converted leaf for leaf: lock-step logits and caches
(the RWKV and Mamba state planes among them) within 1e-4 and greedy tokens
exactly; the ragged model functions (chunks with a padded tail, a batched
advance with an invalid row, a parked row, a K = 4 block with a mid-block
EOS, a release that zeroes the recurrent state); the continuous engine's
greedy tokens exactly at decode_ticks 1 and 4. The ring cases run max_len
256 with prompts longer than the 128-slot ring, so every ring wraps.

On the +w4a8 configs an int8 activation or KV code may land one step off
where the two programs' float32 values straddle a rounding boundary
(``_torch_parity.NEAR_TIES``): rwkv6-3b+w4a8's greedy lock-step tokens are
held teacher-forced, a flip allowed only at a near-tie, and
hymba-1.5b+ring+w4a8's lock-step and ragged checks allow up to two KV codes
one step off at each comparison, then continue from the reference's codes.
Its lock-step prefill at prompt 150 flips one K and one V code of layer 1
(of 61440 each): the two programs' layer-1 K/V inputs differ by at most
1e-5, as far as a one-ulp change of the embedding moves the port's own
(ROADMAP section 3). Both flipped positions lie outside the window that
decode reads, so the greedy tokens are still held exactly."""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from _torch_parity import check_engine, check_lockstep, check_ragged, flat, pair

NAMES = ["rwkv6-3b", "rwkv6-3b+w4a8", "hymba-1.5b", "hymba-1.5b+ring",
         "hymba-1.5b+ring+w4a8"]
# the ring cases: a 128-slot ring (window 32) that every prompt wraps
RING = {"lockstep": dict(prompt=150, max_len=256),
        "ragged": dict(prompt_len=150, max_len=256),
        "engine": dict(prompt_len=(130, 200), max_len=256)}
NEAR = {"rwkv6-3b+w4a8": {"lockstep": dict(near_ties=True)},
        "hymba-1.5b+ring+w4a8": {"lockstep": dict(code_flips=2),
                                 "ragged": dict(code_flips=2)}}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These tests run many tiny ops; with the suite's workers sharing the
    cores, PyTorch's waiting intra-op threads cost more than they give."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _kw(name, check):
    kw = dict(RING[check]) if "+ring" in name else {}
    kw.update(NEAR.get(name, {}).get(check, {}))
    return kw


@pytest.mark.parametrize("name", NAMES)
def test_from_jax_leaf_for_leaf(name):
    _, params, _, tparams = pair(name)
    want = dict(flat(jax.tree.map(np.asarray, params)))
    got = dict(flat(tparams))
    assert got.keys() == want.keys()
    for key, w in want.items():
        assert str(got[key].dtype).removeprefix("torch.") == w.dtype.name, key
        np.testing.assert_array_equal(got[key].numpy(), w, err_msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_lockstep_logits_caches_and_tokens(name):
    check_lockstep(name, **_kw(name, "lockstep"))


@pytest.mark.parametrize("name", NAMES)
def test_ragged_model_functions_match_reference(name):
    check_ragged(name, **_kw(name, "ragged"))


@pytest.mark.parametrize("ticks", [1, 4])
@pytest.mark.parametrize("name", NAMES)
def test_continuous_tokens_match_reference_engine(name, ticks):
    check_engine(name, ticks, **_kw(name, "engine"))


def test_cache_layouts():
    """RWKV6 caches no KV at all: lengths and three state planes (the WKV
    state float32); hymba adds float32 Mamba planes to its KV cache, a
    ring of 128 slots on +ring; the engine's report counts 0 KV rows for
    RWKV6."""
    from repro_torch.serving import ContinuousBatchingEngine, Request
    _, _, tm, tparams = pair("rwkv6-3b")
    cache = tm.init_cache(2, 64)
    assert set(cache) == {"len", "rwkv_att", "rwkv_ffn", "rwkv_wkv"}
    assert cache["rwkv_wkv"].shape == (2, 2, 4, 16, 16)
    eng = ContinuousBatchingEngine(tm, tparams, n_slots=2, max_len=64, chunk=8)
    agg = eng.run([Request(prompt=np.arange(10, dtype=np.int32), max_new_tokens=3)])["aggregate"]
    assert (agg["kv_rows_per_slot"], agg["kv_bytes_per_slot"], agg["n_retired"]) == (0, 0, 1)
    _, _, hm, _ = pair("hymba-1.5b+ring")
    cache = hm.init_cache(2, 256, chunk=8)
    assert cache["k"].shape[2] == 128
    assert cache["mamba_conv"].shape == (2, 2, 3, 128)
    assert cache["mamba_ssm"].shape == (2, 2, 128, 4)
