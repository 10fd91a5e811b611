"""The ``clear_rows`` wrapper's cached fill word (``fill_word``): for
every dtype and fill, its bytes are numpy's pattern of the fill repeated
to the chosen store width, and a second call with another fill on the
same component gives that fill's word.  Runs on the CPU: the word is
what the kernel receives, computed on the host."""

import numpy as np
import pytest
import torch

from flink_tpu_torch.kernels.clear_rows import fill_word

DTYPES = [torch.uint8, torch.int32, torch.float32, torch.int64]
F32 = np.finfo(np.float32)


def _fills(dtype):
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    info = np.finfo(np_dtype) if np_dtype.kind == "f" else np.iinfo(np_dtype)
    return [0, -7, 1.5, float(F32.max), float(F32.min), np_dtype.type(info.max).item(),
            np_dtype.type(info.min).item()]


def _numpy_pattern(dtype, fill):
    np_dtype = torch.empty(0, dtype=dtype).numpy().dtype
    return np.array([fill], dtype=np_dtype).tobytes()


def _word_bytes(lo, hi):
    return lo.to_bytes(8, "little") + hi.to_bytes(8, "little")


# (row bytes, base address mod 16) that a component of the dtype can have
CASES = [(dt, rb, al) for dt in DTYPES
         for rb, al in ((4096, 0), (8, 8), (24, 4), (12, 4), (3, 0), (64, 1))
         if rb % torch.empty(0, dtype=dt).element_size() == 0
         and al % torch.empty(0, dtype=dt).element_size() == 0]


@pytest.mark.parametrize("dtype,row_bytes,align", CASES)
def test_fill_word_is_the_numpy_pattern_repeated(dtype, row_bytes, align):
    for fill in _fills(dtype):
        try:
            pat = _numpy_pattern(dtype, fill)
        except OverflowError:
            with pytest.raises(OverflowError):
                fill_word(dtype, fill, row_bytes, align)
            continue
        width, lo, hi = fill_word(dtype, fill, row_bytes, align)
        assert width in (1, 2, 4, 8, 16)
        assert width % len(pat) == 0 and row_bytes % width == 0
        assert align % width == 0
        # the widest such store
        assert not any(w > width and w % len(pat) == 0 and row_bytes % w == 0
                       and align % w == 0 for w in (2, 4, 8, 16))
        word = _word_bytes(lo, hi)
        assert word[:width] == pat * (width // len(pat)), (dtype, fill)
        assert word[width:] == b"\0" * (16 - width)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fill_word_follows_the_fill_on_one_component(dtype):
    # the Min / Max / Sum fills of one component, in turns: each call
    # gives its own fill's word, whatever was asked before
    fills = [f for f in _fills(dtype)
             if not _raises(lambda f=f: _numpy_pattern(dtype, f))]
    for fill in fills + fills[::-1]:
        width, lo, hi = fill_word(dtype, fill, 4096, 0)
        assert width == 16
        pat = _numpy_pattern(dtype, fill)
        assert _word_bytes(lo, hi) == pat * (16 // len(pat))


def test_fill_word_keeps_negative_zero_apart():
    assert fill_word(torch.float32, 0.0, 4, 0)[1] == 0
    assert fill_word(torch.float32, -0.0, 4, 0)[1] == 0x80000000
    assert fill_word(torch.float32, 0.0, 4, 0)[1] == 0


def test_fill_word_takes_numpy_scalars_as_their_values():
    assert fill_word(torch.float32, np.float32(1.5), 4, 0) == \
        fill_word(torch.float32, 1.5, 4, 0)
    assert fill_word(torch.int32, np.int64(-7), 4, 0) == \
        fill_word(torch.int32, -7, 4, 0)


def _raises(fn):
    try:
        fn()
    except OverflowError:
        return True
    return False
