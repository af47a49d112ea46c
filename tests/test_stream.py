"""Live-ingest stream tests (ref: Examples/ROS/ORB_SLAM2/src/ros_stereo.cc
ApproximateTime sync + subscriber queues) — hermetic over localhost TCP."""

import time

import numpy as np

from corbslam.io.stream import (
    ApproxSync, ImageStreamClient, ImageStreamServer,
)


class TestStreamTransport:
    def test_frames_roundtrip(self):
        srv = ImageStreamServer()
        sub = ImageStreamClient(port=srv.port)
        srv.wait_subscriber(timeout=10)
        imgs = [np.random.default_rng(i).integers(
            0, 255, (24, 32), dtype=np.uint8) for i in range(3)]
        for i, im in enumerate(imgs):
            srv.publish("left", 1.0 + i, im)
        srv.end()
        t0 = time.time()
        got = []
        while len(got) < 3 and time.time() - t0 < 5:
            got += sub.pop_all("left")
            time.sleep(0.01)
        assert len(got) == 3
        for (ts, im), (i, ref) in zip(got, enumerate(imgs)):
            assert ts == 1.0 + i
            assert (im == ref).all()
        t0 = time.time()
        while not sub.ended and time.time() - t0 < 5:
            time.sleep(0.01)
        assert sub.ended
        sub.close()
        srv.close()

    def test_float_dtype(self):
        srv = ImageStreamServer()
        sub = ImageStreamClient(port=srv.port)
        srv.wait_subscriber(timeout=10)
        im = np.linspace(0, 1, 24 * 32, dtype=np.float32).reshape(24, 32)
        srv.publish("depth", 2.5, im)
        t0 = time.time()
        got = []
        while not got and time.time() - t0 < 5:
            got = sub.pop_all("depth")
            time.sleep(0.01)
        assert got and got[0][1].dtype == np.float32
        assert np.allclose(got[0][1], im)
        sub.close()
        srv.close()

    def test_queue_bounded(self):
        """Old frames are dropped when the consumer lags (queue_size
        semantics, ros_stereo.cc:93-96)."""
        srv = ImageStreamServer()
        sub = ImageStreamClient(port=srv.port, queue_size=4)
        srv.wait_subscriber(timeout=10)
        for i in range(10):
            srv.publish("left", float(i),
                        np.full((8, 8), i, np.uint8))
        srv.end()
        t0 = time.time()
        while not sub.ended and time.time() - t0 < 5:
            time.sleep(0.01)
        got = sub.pop_all("left")
        assert len(got) <= 4
        assert got[-1][0] == 9.0  # newest survives
        sub.close()
        srv.close()


class TestApproxSync:
    def test_pairs_within_slop(self):
        s = ApproxSync(slop=0.02)
        s.push_a(1.00, "a0")
        s.push_b(1.01, "b0")
        s.push_a(1.10, "a1")
        s.push_b(1.11, "b1")
        out = s.pop_pairs()
        assert [(p[1], p[2]) for p in out] == [("a0", "b0"), ("a1", "b1")]

    def test_drops_unmatched(self):
        s = ApproxSync(slop=0.02)
        s.push_a(1.00, "a0")    # no b within slop -> dropped
        s.push_b(1.50, "b0")
        s.push_a(1.505, "a1")
        out = s.pop_pairs()
        assert [(p[1], p[2]) for p in out] == [("a1", "b0")]

    def test_rejects_stale_after_emit(self):
        s = ApproxSync(slop=0.02)
        s.push_a(2.0, "a0")
        s.push_b(2.0, "b0")
        assert len(s.pop_pairs()) == 1
        s.push_a(1.0, "old")    # older than last emitted pair -> ignored
        s.push_b(1.0, "old")
        assert s.pop_pairs() == []
