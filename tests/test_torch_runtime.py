"""pint_tpu_torch's checkpoints and checkpointed chunked scan against
pint_tpu's.

* The cases of pint_tpu's ``tests/test_runtime.py`` ``TestCheckpointIO``
  and ``TestChunkedScan`` (CRC32-verified atomic checkpoints; retry,
  requeue and FAILED chunk statuses, the SIGTERM flush and the
  bit-identical resume), each run against the port's ``runtime`` and
  ``faultinject``.
* The checkpoint format is pint_tpu's: a checkpoint either package
  writes loads in the other with the same arrays (bit for bit), a scan
  that one package interrupts the other resumes, and both packages'
  CRCs of the same arrays are equal.
"""

import os

import numpy as np
import pytest

from pint_tpu import runtime as j_runtime
from pint_tpu_torch import faultinject, runtime
from pint_tpu_torch.exceptions import CheckpointCorruptError, ScanInterrupted
from pint_tpu_torch.runtime import ChunkStatus


def _ramp(ci, lo, hi):
    """A deterministic stand-in scan chunk: results = index + 1."""
    return np.arange(lo, hi, dtype=np.float64) + 1.0


def _arrays():
    return {"a": np.arange(5.0), "b": np.int64(7),
            "c": np.random.default_rng(0).standard_normal((3, 2)),
            "signature": np.frombuffer(b"grid|cs=4", np.uint8)}


class TestCheckpointIO:
    def test_roundtrip(self, tmp_path):
        path = str(tmp_path / "ck.npz")
        arrays = {"a": np.arange(5.0), "b": np.int64(7),
                  "c": np.random.default_rng(0).standard_normal((3, 2))}
        runtime.write_checkpoint(path, arrays)
        out = runtime.load_checkpoint(path)
        assert set(out) == {"a", "b", "c"}
        np.testing.assert_array_equal(out["a"], arrays["a"])
        np.testing.assert_array_equal(out["c"], arrays["c"])
        assert int(out["b"]) == 7

    def test_write_is_atomic_no_tmp_left(self, tmp_path):
        path = str(tmp_path / "ck.npz")
        runtime.write_checkpoint(path, {"a": np.zeros(3)})
        assert os.listdir(str(tmp_path)) == ["ck.npz"]

    @pytest.mark.parametrize("mode", ["truncate", "flip"])
    def test_corruption_raises_typed(self, tmp_path, mode):
        """Truncation (unreadable container) and bit rot (the container
        may still unzip: only the CRC32 catches it) both raise the typed
        error, never a numpy or zipfile internal."""
        path = str(tmp_path / "ck.npz")
        runtime.write_checkpoint(path, {"a": np.arange(64.0)})
        with faultinject.corrupt_checkpoint(path, mode=mode):
            with pytest.raises(CheckpointCorruptError):
                runtime.load_checkpoint(path)
        # restored on exit: loads clean again
        np.testing.assert_array_equal(
            runtime.load_checkpoint(path)["a"], np.arange(64.0))

    def test_missing_file_raises_typed(self, tmp_path):
        with pytest.raises(CheckpointCorruptError):
            runtime.load_checkpoint(str(tmp_path / "nope.npz"))


class TestChunkedScan:
    def test_plain_scan_all_ok(self):
        res, s = runtime.run_checkpointed_scan(10, _ramp, chunk_size=4)
        np.testing.assert_array_equal(res, np.arange(10) + 1.0)
        assert s.n_chunks == 3 and s.chunk_size == 4
        assert all(x == ChunkStatus.OK for x in s.statuses)
        assert s.ok and s.retries == s.reroutes == s.failures == 0
        assert s.counts() == {"OK": 3}

    def test_nonfinite_chunk_is_retried(self):
        with faultinject.chunk_nonfinite(chunks=(1,), times=1):
            res, s = runtime.run_checkpointed_scan(10, _ramp,
                                                   chunk_size=4)
        np.testing.assert_array_equal(res, np.arange(10) + 1.0)
        assert s.statuses[1] == ChunkStatus.RETRIED
        assert s.retries == 1 and s.ok

    def test_raising_chunk_requeued_to_fallback(self):
        with faultinject.chunk_raise(chunks=(0,), times=99):
            res, s = runtime.run_checkpointed_scan(
                10, _ramp, chunk_size=4, max_retries=2, fallback=_ramp)
        np.testing.assert_array_equal(res, np.arange(10) + 1.0)
        assert s.statuses[0] == ChunkStatus.REROUTED
        assert s.retries == 2 and s.reroutes == 1 and s.ok

    def test_exhausted_chunk_without_fallback_fails_loudly(self):
        """A chunk that never succeeds is recorded FAILED (NaN results for
        its points); the partial scan is still returned."""
        with faultinject.chunk_raise(chunks=(2,), times=99):
            res, s = runtime.run_checkpointed_scan(10, _ramp,
                                                   chunk_size=4,
                                                   max_retries=1)
        assert s.statuses[2] == ChunkStatus.FAILED and s.failures == 1
        assert not s.ok
        np.testing.assert_array_equal(res[:8], np.arange(8) + 1.0)
        assert np.all(np.isnan(res[8:]))

    def test_sigterm_flushes_and_resume_is_bit_identical(self, tmp_path):
        """SIGTERM mid-scan -> final checkpoint flushed -> typed
        ScanInterrupted; resume skips the completed chunk and the result
        is bit-identical to the uninterrupted run."""
        ck = str(tmp_path / "scan.npz")
        full, _ = runtime.run_checkpointed_scan(10, _ramp, chunk_size=4,
                                                signature="s")
        with faultinject.sigterm_midscan(after_chunk=0):
            with pytest.raises(ScanInterrupted) as ei:
                runtime.run_checkpointed_scan(10, _ramp, chunk_size=4,
                                              checkpoint=ck,
                                              signature="s")
        e = ei.value
        assert e.signum == 15 and e.chunks_done == 1 and e.n_chunks == 3
        assert e.checkpoint == ck and os.path.exists(ck)
        res, s = runtime.run_checkpointed_scan(10, _ramp, chunk_size=4,
                                               checkpoint=ck,
                                               resume=True,
                                               signature="s")
        np.testing.assert_array_equal(res, full)   # bitwise
        assert s.resumed_chunks == 1 and s.ok

    def test_resume_config_mismatch_rejected(self, tmp_path):
        ck = str(tmp_path / "scan.npz")
        runtime.run_checkpointed_scan(10, _ramp, chunk_size=4,
                                      checkpoint=ck, signature="cfgA")
        for kwargs in ({"chunk_size": 5, "signature": "cfgA"},
                       {"chunk_size": 4, "signature": "cfgB"}):
            with pytest.raises(ValueError, match="does not match"):
                runtime.run_checkpointed_scan(10, _ramp, resume=True,
                                              checkpoint=ck, **kwargs)

    def test_resume_from_corrupt_checkpoint_raises_typed(self, tmp_path):
        ck = str(tmp_path / "scan.npz")
        runtime.run_checkpointed_scan(10, _ramp, chunk_size=4,
                                      checkpoint=ck, signature="s")
        with faultinject.corrupt_checkpoint(ck):
            with pytest.raises(CheckpointCorruptError):
                runtime.run_checkpointed_scan(10, _ramp, chunk_size=4,
                                              checkpoint=ck,
                                              resume=True, signature="s")

    def test_failed_chunks_requeued_on_resume(self, tmp_path):
        """A chunk recorded FAILED in the checkpoint runs again on resume;
        completed chunks stay final."""
        ck = str(tmp_path / "scan.npz")
        with faultinject.chunk_raise(chunks=(1,), times=99):
            _, s1 = runtime.run_checkpointed_scan(
                10, _ramp, chunk_size=4, max_retries=0, checkpoint=ck,
                signature="s")
        assert s1.statuses[1] == ChunkStatus.FAILED
        res2, s2 = runtime.run_checkpointed_scan(
            10, _ramp, chunk_size=4, checkpoint=ck, resume=True,
            signature="s")
        assert s2.resumed_chunks == 2          # chunks 0 and 2 skipped
        assert s2.statuses[1] == ChunkStatus.OK and s2.ok
        np.testing.assert_array_equal(res2, np.arange(10) + 1.0)

    def test_bad_chunk_shape_is_an_error(self):
        with pytest.raises(ValueError, match="shape"):
            runtime.run_checkpointed_scan(
                10, lambda ci, lo, hi: np.zeros(99), chunk_size=4)


# --- the format shared with pint_tpu ------------------------------------------

@pytest.mark.parametrize("writer,reader", [
    (j_runtime.write_checkpoint, runtime.load_checkpoint),
    (runtime.write_checkpoint, j_runtime.load_checkpoint)],
    ids=["pint_tpu_to_port", "port_to_pint_tpu"])
def test_checkpoint_loads_across_packages(tmp_path, writer, reader):
    """Bar: the same names, dtypes, shapes and bytes, and a verified
    CRC."""
    path = str(tmp_path / "ck.npz")
    arrays = _arrays()
    writer(path, arrays)
    out = reader(path)
    assert set(out) == set(arrays)
    for k, v in arrays.items():
        assert out[k].dtype == np.asarray(v).dtype, k
        np.testing.assert_array_equal(out[k], v)


def test_crc_and_signature_equal_to_pint_tpu():
    """Bar: equal integers and strings."""
    arrays = _arrays()
    assert runtime._arrays_crc(arrays) == j_runtime._arrays_crc(arrays)
    grid = {"M2": np.array([0.2, 0.25]), "SINI": np.array([0.98, 0.99])}
    assert runtime.scan_signature("grid", grid, ["F0", "A1"], 2, 4) == \
        j_runtime.scan_signature("grid", grid, ["F0", "A1"], 2, 4)


@pytest.mark.parametrize("first,second", [
    (j_runtime, runtime), (runtime, j_runtime)],
    ids=["pint_tpu_then_port", "port_then_pint_tpu"])
def test_scan_interrupted_in_one_resumes_in_the_other(tmp_path, first,
                                                      second):
    """A scan checkpoint one package leaves resumes in the other: bar,
    the result bit-identical to the uninterrupted scan, with the
    completed chunks restored."""
    from pint_tpu import faultinject as j_faultinject

    fi = j_faultinject if first is j_runtime else faultinject
    ck = str(tmp_path / "scan.npz")
    full, _ = runtime.run_checkpointed_scan(10, _ramp, chunk_size=4)
    with fi.sigterm_midscan(after_chunk=1):
        with pytest.raises(Exception) as ei:
            first.run_checkpointed_scan(10, _ramp, chunk_size=4,
                                        checkpoint=ck, signature="s")
    assert type(ei.value).__name__ == "ScanInterrupted"
    res, s = second.run_checkpointed_scan(10, _ramp, chunk_size=4,
                                          checkpoint=ck, resume=True,
                                          signature="s")
    np.testing.assert_array_equal(res, full)
    assert s.resumed_chunks == 2 and s.ok
