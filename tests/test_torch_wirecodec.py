"""The port's d24v wire codec vs the JAX package's, bit for bit.

The port's ``encode_d24v`` must write the JAX package's bytes, and its
plain decode (the reference of the CUDA kernel) must equal both JAX
decoders — ``wirecodec.decode_d24v`` (XLA) and ``pallas_decode.
decode_d24v`` (the TPU kernel, run in interpret mode under ``jax.jit`` as
tests/test_pallas_events.py runs it) — on the probe stream, the codec's
edge cases, and wires no encoder writes (every width, raw and delta, with
block sums that wrap 32 bits).  Inputs come from numpy seeds; ids are
integers, so every comparison is exact.
"""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pluss.ops import pallas_decode
from pluss.ops import wirecodec as jw
from pluss_torch.ops import decode as decode_mod
from pluss_torch.ops import wirecodec as tw
from pluss_torch.ops.decode import decode_d24v

B = jw.BLOCK


def _patterns():
    rng = np.random.default_rng(7)
    seq = np.arange(2 * B, dtype=np.int32) % (1 << 20)
    return {
        # the JAX decode probe's stream (pallas_decode.py:_probe_impl)
        "probe": np.concatenate([
            seq, np.random.default_rng(0).integers(0, 1 << 24, 2 * B)
            .astype(np.int32), seq[::4]]),
        "random24": rng.integers(0, 1 << 24, 5000).astype(np.int32),
        "sequential": np.arange(3000, dtype=np.int32),
        "seq_high": (np.arange(5000, dtype=np.int32) % 4096) + (1 << 22),
        "ragged_tail": rng.integers(0, 1 << 10, 3 * B + 37).astype(np.int32),
        "tiny_ragged": np.arange(37, dtype=np.int32) * 5,
        "single": np.array([7], np.int32),
        "zeros": np.zeros(2 * B, np.int32),
        # k=0 runs: a constant block continues the previous block's id
        "k0_runs": np.repeat(np.array([5, 1 << 23, 1 << 23, 9], np.int32), B),
        "ids_at_ceiling": np.array([0, (1 << 24) - 1, 1, (1 << 24) - 2] * 700,
                                   np.int32),
        "descending": ((1 << 24) - 1 - 3 * np.arange(3 * B)).astype(np.int32),
        # noisy (raw) blocks between sequential (delta) blocks: each raw
        # block resets the delta chain
        "raw_resets": np.concatenate([
            rng.integers(0, 1 << 23, B).astype(np.int32) if i % 2 else
            (np.arange(B, dtype=np.int32) + (1 << 20)) for i in range(8)]),
        "width_ladder": np.concatenate([
            np.minimum(rng.integers(0, 1 << min(4 * k, 24), B),
                       (1 << 24) - 1).astype(np.int32) for k in range(7)]),
    }


PATTERNS = _patterns()


def random_wire(seed, n_blocks=6, max_k=7):
    """A wire no encoder writes: random widths 0..max_k, raw or delta,
    and random payload bytes.  Delta blocks of width 6 sum 1024 zigzag
    values up to 2^23 each, so block sums and their prefix wrap 32 bits."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, max_k + 1, n_blocks)
    k[:3] = [6, 6, 6]   # a wrapping delta chain at the batch head
    raw = rng.random(n_blocks) < 0.3
    raw[:3] = False
    wm = (k | np.where(raw, jw.RAW_MODE, 0)).astype(np.uint8)
    payload = rng.integers(0, 256, jw.pad_len(jw.used_bytes(wm)),
                           dtype=np.uint8)
    return payload, wm


def plain(payload, wm):
    return tw.decode_d24v_plain(torch.from_numpy(payload),
                                torch.from_numpy(wm)).numpy()


def jax_xla(payload, wm):
    return np.asarray(jw.decode_d24v(jnp.asarray(payload), jnp.asarray(wm)))


def jax_pallas(payload, wm):
    # the jit executes the interpret-mode pallas_call (no eager eval rule)
    return np.asarray(jax.jit(pallas_decode.decode_d24v)(
        jnp.asarray(payload), jnp.asarray(wm)))


def test_constants_and_padding_match_jax():
    assert (tw.BLOCK, tw.RAW_MODE, tw.MAX_ID) == (jw.BLOCK, jw.RAW_MODE,
                                                  jw.MAX_ID)
    for n in [0, 1, 3, 4, 100, 4095, 4096, 4097, 70_000, 10**7]:
        assert tw.pad_len(n) == jw.pad_len(n)
    wm = np.arange(256, dtype=np.uint8)
    assert tw.used_bytes(wm) == jw.used_bytes(wm)


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_encode_writes_the_jax_bytes(name):
    ids = PATTERNS[name]
    p_t, w_t = tw.encode_d24v(ids)
    p_j, w_j = jw.encode_d24v(ids)
    np.testing.assert_array_equal(w_t, w_j)
    np.testing.assert_array_equal(p_t, p_j)


@pytest.mark.parametrize("name", sorted(PATTERNS))
def test_plain_decode_matches_both_jax_decoders(name):
    ids = PATTERNS[name]
    payload, wm = tw.encode_d24v(ids)
    got = plain(payload, wm)
    assert got.dtype == np.int32 and got.shape == (len(wm) * B,)
    np.testing.assert_array_equal(got, jax_xla(payload, wm))
    np.testing.assert_array_equal(got, jax_pallas(payload, wm))
    np.testing.assert_array_equal(got[:len(ids)], ids)   # decode(encode)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_decode_matches_jax_on_wires_no_encoder_writes(seed):
    # the Pallas kernel unpacks widths 0-6 only (the format's range)
    payload, wm = random_wire(seed, max_k=6)
    got = plain(payload, wm)
    np.testing.assert_array_equal(got, jax_xla(payload, wm))
    np.testing.assert_array_equal(got, jax_pallas(payload, wm))
    # the wrapping chain: the true (unwrapped) sum leaves the int32 range
    k = (wm & 7).astype(np.int64)
    assert k[:3].tolist() == [6, 6, 6]
    payload, wm = random_wire(seed + 10, max_k=7)
    np.testing.assert_array_equal(plain(payload, wm), jax_xla(payload, wm))


def test_plain_decode_sums_wrap_like_int32():
    """A chain of delta blocks of all-ones nibbles: each value is the
    zigzag of -2^23, so block sums leave the int32 range within a few
    blocks and the ids wrap modulo 2^32."""
    wm = np.full(4, 6, np.uint8)
    payload = np.zeros(jw.pad_len(jw.used_bytes(wm)), np.uint8)
    payload[:jw.used_bytes(wm)] = 0xFF
    got = plain(payload, wm)
    want = (np.arange(1, 4 * B + 1, dtype=np.int64) * -(1 << 23))
    want = ((want + 2**31) % 2**32 - 2**31).astype(np.int32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_xla(payload, wm))


@pytest.mark.parametrize("seed", range(4))
def test_roundtrip_random_ragged(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 6 * B))
    ids = rng.integers(0, 1 << int(rng.integers(1, 25)), n).astype(np.int32)
    payload, wm = tw.encode_d24v(ids)
    assert payload.nbytes == tw.pad_len(tw.used_bytes(wm))
    np.testing.assert_array_equal(plain(payload, wm)[:n], ids)


def test_encode_rejects_out_of_range_and_empty():
    with pytest.raises(ValueError):
        tw.encode_d24v(np.array([1 << 24], np.int32))
    with pytest.raises(ValueError):
        tw.encode_d24v(np.array([-1], np.int32))
    with pytest.raises(ValueError):
        tw.encode_d24v(np.zeros(0, np.int32))


def test_wrapper_takes_plain_version_on_cpu():
    payload, wm = (torch.from_numpy(a) for a in
                   tw.encode_d24v(PATTERNS["raw_resets"]))
    before = decode_d24v.launches
    assert torch.equal(decode_d24v(payload, wm),
                       tw.decode_d24v_plain(payload, wm))
    assert decode_d24v.launches == before   # no kernel launched


def test_wrapper_checks_its_inputs():
    payload, wm = (torch.from_numpy(a) for a in
                   tw.encode_d24v(PATTERNS["sequential"]))
    bad = [
        (payload.to(torch.int32), wm),         # payload dtype
        (payload, wm.to(torch.int16)),         # wm dtype
        (payload[:-1], wm),                    # not a whole number of words
        (payload.view(-1, 4), wm),             # not 1-D
        (payload[::2], wm),                    # strided
        (payload, wm[:0]),                     # no blocks
    ]
    for args in bad:
        with pytest.raises(ValueError):
            decode_d24v(*args)


def test_cuda_branch_never_reaches_plain_version(monkeypatch):
    """The plain version is called only under the CPU test of the wrapper;
    the kernel branch never names it, and a tensor on any other device is
    refused without falling back."""
    tree = ast.parse(inspect.getsource(decode_mod.decode_d24v))
    calls = [n for n in ast.walk(tree) if isinstance(n, ast.Call)
             and getattr(n.func, "id", "") == "decode_d24v_plain"]
    assert len(calls) == 1
    cpu_if = [n for n in ast.walk(tree) if isinstance(n, ast.If)
              and "'cpu'" in ast.unparse(n.test)]
    assert len(cpu_if) == 1 and calls[0] in list(ast.walk(cpu_if[0]))
    assert "plain" not in inspect.getsource(decode_mod._launch)

    def refuse(*a):
        raise AssertionError("plain version reached off the CPU")

    monkeypatch.setattr(decode_mod, "decode_d24v_plain", refuse)
    monkeypatch.setattr(decode_mod, "_launch", refuse)
    payload, wm = (torch.from_numpy(a).to("meta") for a in
                   tw.encode_d24v(PATTERNS["sequential"]))
    with pytest.raises(ValueError, match="no d24v decode kernel"):
        decode_d24v(payload, wm)
