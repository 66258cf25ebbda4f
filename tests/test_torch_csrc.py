"""apex_tpu_torch.csrc's native runtime against apex_tpu.csrc on the CPU:
``flatten`` gives the same bytes and ``unflatten`` round-trips; the native
``TokenLoader`` yields the JAX loader's batches (several files, ``loop``,
the ragged tail dropped, independent iterators, a missing file raising),
and so does its Python path where the runtime is absent. The runtime is
host code built with ``g++``, so it runs here as on the card's host."""

import itertools

import numpy as np
import pytest

from apex_tpu import csrc as jcsrc
from apex_tpu_torch import csrc
from apex_tpu_torch.csrc import runtime


def _arrays():
    rng = np.random.default_rng(0)
    return [rng.standard_normal((3, 5)).astype(np.float32),
            rng.integers(0, 100, (7,)).astype(np.int32),
            np.arange(11, dtype=np.int64)[::2],  # a strided view
            rng.standard_normal((2, 2, 2)).astype(np.float16),
            np.zeros((0,), np.float32)]


def test_the_native_runtime_builds_here():
    assert csrc.available()
    assert runtime.library_path().endswith(".so")


@pytest.mark.parametrize("threads", [1, 4])
def test_flatten_bytes_match_and_unflatten_round_trips(threads):
    arrays = _arrays()
    flat = csrc.flatten(arrays, threads=threads)
    ref = jcsrc.flatten(arrays, threads=threads)
    assert flat.dtype == np.uint8 and np.array_equal(flat, ref)
    back = csrc.unflatten(flat, arrays, threads=threads)
    for a, b in zip(arrays, back):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    with pytest.raises(ValueError, match="templates"):
        csrc.unflatten(flat[:-1], arrays)
    assert csrc.flatten([]).size == 0 and csrc.unflatten(flat[:0], []) == []


def _write_files(tmp_path, sizes):
    paths, start = [], 0
    for i, n in enumerate(sizes):
        p = tmp_path / f"shard{i}.bin"
        np.arange(start, start + n, dtype=np.int32).tofile(p)
        paths.append(str(p))
        start += n
    return paths


def _take(it, n):
    return [a.copy() for a in itertools.islice(it, n)]


@pytest.fixture(params=["native", "python"])
def path_kind(request, monkeypatch):
    """Both paths of the port's loader: the native stream, and the Python
    reader the reference keeps for a machine with no compiler."""
    if request.param == "python":
        monkeypatch.setattr(runtime, "available", lambda: False)
    else:
        assert runtime.available()
    return request.param


def test_token_loader_matches_the_jax_loader(tmp_path, path_kind):
    # 3 files of 37 + 50 + 29 tokens, batches of 2 x 9: the batches cross
    # the file boundaries and a ragged tail of 116 % 18 = 8 tokens drops
    paths = _write_files(tmp_path, (37, 50, 29))
    got = list(csrc.TokenLoader(paths, (2, 9)))
    want = list(jcsrc.TokenLoader(paths, (2, 9)))
    assert len(got) == len(want) == 116 // 18
    for a, b in zip(got, want):
        assert a.dtype == np.int32 and a.shape == (2, 9)
        assert np.array_equal(a, b)
    assert np.array_equal(np.concatenate(got).ravel(), np.arange(108))


def test_token_loader_loops_and_iterators_are_independent(tmp_path,
                                                          path_kind):
    paths = _write_files(tmp_path, (20, 13))
    loader = csrc.TokenLoader(paths, (5,), loop=True)
    ref = jcsrc.TokenLoader(paths, (5,), loop=True)
    a, b = iter(loader), iter(loader)
    first = _take(a, 9)  # past one pass: 33 tokens, 6 batches + carry
    assert [x.tolist() for x in first] == [
        x.tolist() for x in _take(iter(ref), 9)]
    # the second iterator restarts the stream from its first batch
    assert [x.tolist() for x in _take(b, 3)] == [
        x.tolist() for x in first[:3]]
    loader.close()
    ref.close()


def test_token_loader_missing_file_raises(tmp_path, path_kind):
    paths = _write_files(tmp_path, (10,))
    with pytest.raises(FileNotFoundError):
        csrc.TokenLoader(paths + [str(tmp_path / "absent.bin")], (2,))
    with pytest.raises(ValueError, match="no input files"):
        csrc.TokenLoader([], (2,))


def test_pretrain_gpt_reads_its_data_through_the_native_stream(tmp_path):
    """``pretrain_gpt --data DIR`` streams its rows through the loader,
    which takes the native path here."""
    import argparse

    from apex_tpu_torch.examples.gpt import pretrain_gpt

    _write_files(tmp_path, (100, 60))
    args = argparse.Namespace(data=str(tmp_path), seq=7, vocab=1000)
    toks, tgts = next(pretrain_gpt.batches(args, 2))
    assert csrc.available()
    rows = np.arange(16).reshape(2, 8)
    assert np.array_equal(toks.numpy(), rows[:, :-1])
    assert np.array_equal(tgts.numpy(), rows[:, 1:])


def test_kernel_build_runs_once_across_processes(tmp_path):
    """Two processes reach the build together: under the file lock in the
    build directory one compiles, the other waits and loads its library
    (``csrc.build.build_once``, around ``build.load``'s nvcc build)."""
    from torch_dp_workers import locked_build, run_ranks

    path, counter = str(tmp_path / "lib.so"), str(tmp_path / "builds")
    got = run_ranks(locked_build, 2, tmp_path, path, counter)
    assert got == ["built", "built"]
    with open(counter) as f:
        assert len(f.read().split()) == 1
