"""The whole slice: zstd_tpu_torch's BatchDecoder on the CPU.

decode_frames on the mixed batch of test_torch_framer (libzstd levels 1, 3
and 19, the package's own encoder, multi-block, raw, RLE, dictionary, no
checksum, malformed) is byte-equal to zstd_tpu's BatchDecoder, to the host
oracle and to libzstd. A corrupted frame returns None and poisons only its
own lane; the chained dictionary frame (its content seeds the history)
decodes on the device, with no frame sent to the host; serving mode flags a
frame whose checksum field was flipped.
"""

import numpy as np
import pytest
import torch
import zstandard

from test_torch_framer import mixed_frames
from zstd_tpu.models.batch_decoder import BatchDecoder as RefDecoder
from zstd_tpu.models.framer import Framer as RefFramer
from zstd_tpu.oracle.dictionary import Dictionary as RefDictionary
from zstd_tpu_torch.models.batch_decoder import BatchDecoder
from zstd_tpu_torch.models.splitter import decode_all_device
from zstd_tpu_torch.oracle import Dictionary, decode_all
from zstd_tpu_torch.ops import execute, huffman, sequence, xxhash64

CHAINED = 8  # the dictionary frame without a content size


@pytest.fixture(scope="module")
def mixed():
    return mixed_frames()


@pytest.fixture(scope="module")
def decoded(mixed):
    frames, _, dict_bytes = mixed
    dec = BatchDecoder(device="cpu")
    dec.add_dict(dict_bytes)
    return dec, dec.decode_frames(frames)


def _oracle(frame, dict_bytes):
    try:
        return decode_all(frame, dicts=[Dictionary.decode_dict(dict_bytes)])
    except Exception:
        return None


def test_decode_matches_payloads_oracle_and_libzstd(mixed, decoded):
    frames, payloads, dict_bytes = mixed
    dec, out = decoded
    zd = zstandard.ZstdCompressionDict(dict_bytes)
    for i, (f, p, got) in enumerate(zip(frames, payloads, out)):
        assert got == p, i
        assert got == _oracle(f, dict_bytes), i
        if p is not None:
            d = zstandard.ZstdDecompressor(dict_data=zd)
            assert d.decompressobj().decompress(f) == got, i


def test_decode_matches_reference_decoder(mixed, decoded):
    frames, _, dict_bytes = mixed
    ref = RefDecoder()
    ref.add_dict(dict_bytes)
    assert decoded[1] == ref.decode_frames(frames)


def test_bad_frames_poison_only_their_lanes(mixed, decoded):
    _, payloads, _ = mixed
    _, out = decoded
    assert [i for i, o in enumerate(out) if o is None] == [10, 11, 12]
    assert all(o == p for o, p in zip(out, payloads) if p is not None)


def test_chained_frame_decodes_on_device(mixed):
    frames, payloads, dict_bytes = mixed
    dec = BatchDecoder(device="cpu")
    dec.add_dict(dict_bytes)
    batch = dec.prepare(frames[CHAINED:CHAINED + 2])
    assert batch.metas[0].dict_prefill and not batch.metas[0].fallback
    outputs, out_len, ok = dec.run_device(batch)
    r = batch.metas[0].rows[0]
    assert bool(ok[r])
    assert outputs[r][:int(out_len[r])].tobytes() == payloads[CHAINED]
    assert dec._postprocess(frames[CHAINED:CHAINED + 2], batch, outputs,
                            out_len, ok) == payloads[CHAINED:CHAINED + 2]
    assert dec.host_frames == 0


def test_serving_mode_flags_flipped_checksum(mixed):
    frames, _, dict_bytes = mixed
    flipped = bytearray(frames[0])
    flipped[-1] ^= 0x01  # the content checksum's last byte
    batch_frames = [frames[0], bytes(flipped), frames[3], frames[7]]
    dec = BatchDecoder(device="cpu")
    dec.add_dict(dict_bytes)
    batch = dec.prepare(batch_frames)
    _, _, ok = dec.run_device(batch, dec.stage(batch), pull_outputs=False)
    rows = [m.rows[0] for m in batch.metas]
    assert [bool(ok[r]) for r in rows] == [True, False, True, True]
    # pulled outputs are verified on the host instead: the same verdict
    out = dec.decode_frames(batch_frames)
    assert out[1] is None and None not in (out[0], out[2], out[3])


def test_pipelined_matches_sequential(mixed, decoded):
    frames, _, dict_bytes = mixed
    dec = BatchDecoder(device="cpu")
    dec.add_dict(dict_bytes)
    got = list(dec.decode_frames_pipelined([frames[:5], frames[5:]]))
    assert got[0] + got[1] == decoded[1]


def test_stage_takes_the_reference_framers_batch(mixed, decoded):
    """The DeviceBatch crossing into stage() may come from zstd_tpu."""
    frames, _, dict_bytes = mixed
    d = RefDictionary.decode_dict(dict_bytes)
    fr = RefFramer(dicts={d.dict_id: d})
    for i, f in enumerate(frames):
        fr.add_frame(f, i)
    batch = fr.build()
    dec = BatchDecoder(device="cpu")
    dec.add_dict(dict_bytes)
    outputs, out_len, ok = dec.run_device(batch)
    assert dec._postprocess(frames, batch, outputs, out_len, ok) == \
        decoded[1]


def test_cpu_path_launches_no_kernel(mixed):
    frames, payloads, _ = mixed
    fns = (huffman.huffman_lanes, sequence.sequence_lanes,
           execute.execute_lanes, xxhash64.xxh64_low32_lanes)
    before = [f.launches for f in fns]
    dec = BatchDecoder(device="cpu")
    batch = dec.prepare(frames[:4])
    dec.run_device(batch, pull_outputs=False)
    assert [f.launches for f in fns] == before


def test_decode_all_device_on_a_stream(mixed):
    frames, payloads, _ = mixed
    data = b"".join(frames[:4]) + frames[9]
    assert decode_all_device(data, device="cpu") == \
        b"".join(payloads[:4]) + payloads[9]


def test_default_device_is_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchDecoder()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decode_all_device(b"")


def test_empty_batch():
    dec = BatchDecoder(device="cpu")
    assert dec.decode_frames([]) == []
    batch = dec.prepare([b""])
    assert dec.decode_frames([b""]) == [None]
    assert len(batch.metas) == 1 and not batch.metas[0].ok
    assert np.asarray(batch.out_len).shape == (1,)
