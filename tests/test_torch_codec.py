"""The port's Codec and BatchingCodec (glusterfs_tpu_torch.ops) on the
CPU against the JAX package's ``Codec(backend="ref")``: encode, decode,
encode_delta and reassemble, plain and systematic.  Tolerance: exact
byte equality."""

import asyncio
import itertools

import numpy as np
import pytest
import torch

from glusterfs_tpu.ops.codec import Codec as JaxCodec
from glusterfs_tpu_torch.ops import gf256_cuda
from glusterfs_tpu_torch.ops.batch import BatchingCodec
from glusterfs_tpu_torch.ops.codec import Codec

K, R = 4, 2
N = K + R
STRIPE = K * 512


def _rand(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8)


def _pair(k, r, systematic, backend="torch"):
    dev = "cpu" if backend.startswith("torch") else None
    return (Codec(k, r, backend, systematic=systematic, device=dev),
            JaxCodec(k, r, "ref", systematic=systematic))


@pytest.mark.parametrize("backend", ["torch", "torch-mma", "ref"])
@pytest.mark.parametrize("systematic", [False, True])
@pytest.mark.parametrize("k,r", [(4, 2), (8, 4), (16, 4)])
def test_encode_decode_match_jax_ref(k, r, systematic, backend):
    port, ref = _pair(k, r, systematic, backend)
    data = _rand(5 * k * 512, seed=k + 10 * systematic)
    frags = port.encode(data)
    assert np.array_equal(frags, ref.encode(data))
    for seed in range(3):
        rows = sorted(np.random.default_rng(seed).choice(
            k + r, k, replace=False).tolist())
        got = port.decode(frags[rows], rows)
        assert np.array_equal(got, ref.decode(frags[rows], rows))
        assert np.array_equal(got, data)


@pytest.mark.parametrize("backend", ["torch", "torch-mma", "native"])
@pytest.mark.parametrize("systematic", [False, True])
def test_every_4p2_mask(systematic, backend):
    port, ref = _pair(K, R, systematic, backend)
    data = _rand(3 * STRIPE, seed=5)
    frags = ref.encode(data)
    for rows in itertools.combinations(range(N), K):
        got = port.decode(frags[list(rows)], rows)
        assert np.array_equal(got, data), rows


@pytest.mark.parametrize("systematic", [False, True])
@pytest.mark.parametrize("k,r", [(4, 2), (8, 4), (16, 4)])
def test_native_matches_jax_native(k, r, systematic):
    """The port's native codec against the JAX package's native codec:
    encode, decode (the CSE'd program of the mask) and the delta."""
    port = Codec(k, r, "native", systematic=systematic)
    jax = JaxCodec(k, r, "native", systematic=systematic)
    assert port.device is None
    data = _rand(129 * k * 512, seed=k + 20 * systematic)
    frags = port.encode(data)
    assert np.array_equal(frags, jax.encode(data))
    for seed in range(3):
        rows = sorted(np.random.default_rng(seed + 5).choice(
            k + r, k, replace=False).tolist())
        got = port.decode(frags[rows], rows)
        assert np.array_equal(got, jax.decode(frags[rows], rows))
        assert np.array_equal(got, data)
    if systematic:
        assert np.array_equal(port.encode_delta(data),
                              jax.encode_delta(data))
    with pytest.raises(ValueError):
        Codec(k, r, "native", device="cuda")  # the host only


def test_encode_delta_matches_jax_ref():
    port, ref = _pair(K, R, True)
    delta = _rand(7 * STRIPE, seed=6)
    got = port.encode_delta(delta)
    assert got.shape == (R, 7 * 512)
    assert np.array_equal(got, ref.encode_delta(delta))
    with pytest.raises(ValueError):
        _pair(K, R, False)[0].encode_delta(delta)


def test_reassemble_matches_jax_ref():
    port, ref = _pair(K, R, True)
    data = _rand(3 * STRIPE, seed=7)
    frags = port.encode(data)
    rows = [2, 0, 3, 1]
    # short buffers zero-fill, as the EC layer's sparse tails do
    bufs = [frags[r].tobytes()[: 3 * 512 - 100 * i]
            for i, r in enumerate(rows)]
    got = port.reassemble(bufs, rows, 3 * 512)
    assert np.array_equal(got, ref.reassemble(bufs, rows, 3 * 512))
    assert port.reassemble(bufs, [0, 1, 2, 4], 3 * 512) is None
    assert _pair(K, R, False)[0].reassemble(bufs, rows, 3 * 512) is None


def test_padded_helpers():
    port, ref = _pair(K, R, False)
    data = _rand(STRIPE + 77, seed=8)
    frags, nbytes = port.encode_padded(data)
    assert np.array_equal(frags, ref.encode_padded(data)[0])
    assert np.array_equal(port.decode_padded(frags[[1, 2, 4, 5]],
                                             [1, 2, 4, 5], nbytes), data)


def test_backends_never_pick_the_cpu_implicitly():
    with pytest.raises(ValueError):
        Codec(K, R, "torch")  # the CPU must be asked for by name
    with pytest.raises(ValueError):
        Codec(K, R, "cuda", device="cpu")
    with pytest.raises(ValueError):
        Codec(K, R, "torch-mma")
    with pytest.raises(ValueError):
        Codec(K, R, "cuda-mma", device="cpu")
    with pytest.raises(ValueError):
        Codec(K, R, "pallas-xor")
    with pytest.raises(ValueError):
        Codec(K, R, "pallas-mxu")  # the port's counterpart is cuda-mma
    if not torch.cuda.is_available():
        for backend in ("auto", "cuda", "cuda-mma"):
            with pytest.raises(RuntimeError):
                Codec(K, R, backend)


def test_batching_coalesces_encodes_and_groups_decodes():
    codec = BatchingCodec(K, R, "torch", device="cpu", window=0.005,
                          min_batch=0)
    ref = JaxCodec(K, R, "ref")
    datas = [_rand(STRIPE * (i + 1), i) for i in range(8)]

    async def enc():
        return await asyncio.gather(*(codec.encode_async(d) for d in datas))

    outs = asyncio.run(enc())
    assert codec.launches == 1 and codec.max_batch == 8
    for d, o in zip(datas, outs):
        assert np.array_equal(o, ref.encode(d))

    masks = [(0, 1, 2, 3), (1, 3, 4, 5), (0, 1, 2, 3)]

    async def dec():
        return await asyncio.gather(*(
            codec.decode_async(o[list(m)], m)
            for o, m in zip(outs, masks)))

    got = asyncio.run(dec())
    assert codec.launches == 3  # one more launch per distinct mask
    for d, g in zip(datas, got):
        assert np.array_equal(g, d)
    codec.close()


def test_batching_delta_queue():
    codec = BatchingCodec(K, R, "torch", device="cpu", window=0.005,
                          min_batch=0, systematic=True)
    ref = JaxCodec(K, R, "ref", systematic=True)
    deltas = [_rand(STRIPE * 2, 20 + i) for i in range(4)]

    async def run():
        return await asyncio.gather(*(codec.encode_delta_async(d)
                                      for d in deltas))

    outs = asyncio.run(run())
    assert codec.launches == 1 and codec.max_batch == 4
    for d, o in zip(deltas, outs):
        assert np.array_equal(o, ref.encode_delta(d))
    stats = codec.dump_stats()
    assert stats["backend"] == "torch" and stats["device"] == "cpu"
    codec.close()


def test_cpu_codec_counts_no_kernel_launches():
    gf256_cuda.reset_launches()
    port, _ = _pair(K, R, False)
    port.decode(port.encode(_rand(STRIPE, 9))[[0, 2, 4, 5]], [0, 2, 4, 5])
    assert sum(gf256_cuda.LAUNCHES.values()) == 0


@pytest.mark.parametrize("systematic", [False, True])
def test_torch_mma_batching_and_delta(systematic):
    """The mma backend through the batcher: coalesced encodes and
    same-mask decodes, plus the systematic delta (on the fused parity
    kernel's plain version, as pallas-mxu rides the fused kernels)."""
    codec = BatchingCodec(K, R, "torch-mma", device="cpu", window=0.005,
                          min_batch=0, systematic=systematic)
    ref = JaxCodec(K, R, "ref", systematic=systematic)
    datas = [_rand(STRIPE * (i + 1), 30 + i) for i in range(4)]

    async def enc():
        return await asyncio.gather(*(codec.encode_async(d) for d in datas))

    outs = asyncio.run(enc())
    assert codec.max_batch == 4
    rows = (1, 2, 4, 5)

    async def dec():
        return await asyncio.gather(*(codec.decode_async(o[list(rows)], rows)
                                      for o in outs))

    for d, o, g in zip(datas, outs, asyncio.run(dec())):
        assert np.array_equal(o, ref.encode(d))
        assert np.array_equal(g, d)
    if systematic:
        delta = _rand(2 * STRIPE, 40)
        assert np.array_equal(codec.encode_delta(delta),
                              ref.encode_delta(delta))
    assert codec.dump_stats()["backend"] == "torch-mma"
    codec.close()
