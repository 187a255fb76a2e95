"""Running max / min (kernels/scan.py): the wrapper's plain path on CPU
tensors against numpy's accumulate, its refusals, and the CUDA kernel
against the plain version on a card, over sizes around the kernel's tile,
both dtypes, both directions, the dtypes' extremes, a misaligned view and
a non-default stream; on the card, the counter of the trace counts each
launch.

Tolerance: exact equality (integer max and min).
"""

import numpy as np
import pytest
import torch

from mumemto_tpu_torch import bench, trace
from mumemto_tpu_torch.kernels import scan

# several test workers share the machine's cores
torch.set_num_threads(2)

TILE_BYTES = 32768  # a block's tile in csrc/scan.cu (kTileBytes)
DTYPES = {"int32": (torch.int32, np.int32), "int64": (torch.int64, np.int64)}
# size and contents; a size in tiles is counted in the dtype's own tile
KINDS = ["empty", "one", "tile-1", "tile", "tile+1", "many ragged",
         "all equal", "descending", "extremes"]


def _input(kind: str, np_dtype, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    info = np.iinfo(np_dtype)
    tile = TILE_BYTES // np.dtype(np_dtype).itemsize
    n = {"empty": 0, "one": 1, "tile-1": tile - 1, "tile": tile,
         "tile+1": tile + 1, "many ragged": 37 * tile + 1234,
         "all equal": 3 * tile + 5, "descending": 5 * tile + 17,
         "extremes": 4 * tile + 3}[kind]
    if kind == "all equal":
        return np.full(n, -7, np_dtype)
    if kind == "descending":
        return np.arange(n, 0, -1).astype(np_dtype)
    if kind == "extremes":
        x = rng.integers(-5, 5, n).astype(np_dtype)
        x[rng.integers(0, n, 40)] = info.min
        x[rng.integers(0, n, 40)] = info.max
        x[0], x[-1] = info.max, info.min
        return x
    return rng.integers(info.min, info.max, n, dtype=np_dtype,
                        endpoint=True)


def _want(x: np.ndarray, op: str, reverse: bool) -> np.ndarray:
    acc = {"max": np.maximum, "min": np.minimum}[op].accumulate
    return acc(x[::-1])[::-1] if reverse else acc(x)


def _call(x: torch.Tensor, op: str, reverse: bool) -> torch.Tensor:
    fn = {"max": scan.running_max, "min": scan.running_min}[op]
    return fn(x, reverse=reverse)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("op", ["max", "min"])
def test_cpu_matches_numpy(op, reverse, dtype, kind):
    """A CPU tensor takes the plain version, counts no launch and equals
    numpy's running max / min."""
    t_dtype, np_dtype = DTYPES[dtype]
    x = _input(kind, np_dtype)
    got, _s, launches = bench.counted(
        torch, lambda: _call(torch.from_numpy(x), op, reverse))
    assert launches["running_scan"] == 0
    assert got.dtype == t_dtype and got.shape == (x.size,)
    assert np.array_equal(got.numpy(), _want(x, op, reverse))
    assert np.array_equal(scan.running_plain(torch.from_numpy(x), op,
                                             reverse).numpy(), got.numpy())


@pytest.mark.parametrize("bad", ["float", "int16", "2-D", "strided", "0-D"])
def test_wrapper_rejects_bad_input(bad):
    x = {"float": torch.zeros(16), "int16": torch.zeros(16, dtype=torch.int16),
         "2-D": torch.zeros((4, 4), dtype=torch.int32),
         "strided": torch.zeros(32, dtype=torch.int32)[::2],
         "0-D": torch.zeros((), dtype=torch.int64)}[bad]
    for fn in (scan.running_max, scan.running_min):
        with pytest.raises(ValueError):
            fn(x)
    with pytest.raises(ValueError):
        scan.running_plain(x, "max")


# --- on the card ---------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _same_on_card(x: torch.Tensor, op: str, reverse: bool) -> None:
    got, _s, launches = bench.counted(torch, lambda: _call(x, op, reverse))
    assert launches["running_scan"] == (x.numel() > 0)
    want = scan.running_plain(x, op, reverse)
    assert got.dtype == x.dtype and got.shape == x.shape
    assert int((got != want).sum()) == 0, (op, reverse, x.dtype, x.numel())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_cuda_kernel_matches_plain(dtype, kind):
    """The CPU grid on the card, both ops and directions."""
    dev = _card()
    x = torch.from_numpy(_input(kind, DTYPES[dtype][1])).to(dev)
    for op in ("max", "min"):
        for reverse in (False, True):
            _same_on_card(x, op, reverse)


@pytest.mark.gpu
def test_cuda_kernel_at_main_path_shapes():
    """2^24 + 3 random int32, 2^26 of where(mask, idx, -1) as the
    dictionary's group scan makes it, and both directions at int64."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randint(-2**31, 2**31 - 1, ((1 << 24) + 3,), dtype=torch.int32,
                      device=dev, generator=g)
    for op in ("max", "min"):
        for reverse in (False, True):
            _same_on_card(x, op, reverse)
    n = 1 << 26
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    valid = torch.rand(n, device=dev, generator=g) < 0.3
    _same_on_card(torch.where(valid, idx, -1), "max", False)
    _same_on_card(torch.where(valid, idx, n), "min", True)
    w = torch.randint(-2**62, 2**62, ((1 << 22) + 77,), dtype=torch.int64,
                      device=dev, generator=g)
    for op in ("max", "min"):
        for reverse in (False, True):
            _same_on_card(w, op, reverse)


@pytest.mark.gpu
def test_cuda_kernel_misaligned_view_and_side_stream():
    """A view off a 16-byte boundary takes the element loads; a launch on a
    non-default stream runs on that stream."""
    dev = _card()
    whole = torch.randint(-1000, 1000, (300007,), dtype=torch.int32,
                          device=dev)
    for off in (1, 3):
        view = whole[off:]
        assert view.data_ptr() % 16 != 0
        _same_on_card(view, "max", False)
        _same_on_card(view, "min", True)
    side = torch.cuda.Stream(device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        x = torch.randint(-2**31, 2**31 - 1, ((1 << 22) + 9,),
                          dtype=torch.int32, device=dev)
        got = scan.running_max(x, reverse=True)
        want = scan.running_plain(x, "max", reverse=True)
        same = bool((got == want).all())
    torch.cuda.synchronize()
    assert same


@pytest.mark.gpu
def test_cuda_launch_is_counted_in_the_trace():
    dev = _card()
    x = torch.arange(100000, dtype=torch.int64, device=dev)
    trace.disable()
    trace.drain()
    trace.enable()
    try:
        with trace.call("engine.find_matches") as root:
            scan.running_max(x)
            scan.running_min(x, reverse=True)
            scan.running_max(x[:0])
    finally:
        trace.disable()
    assert trace.drain()["counters"] == {root.id: {scan.COUNTER: 2}}
