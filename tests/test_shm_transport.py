"""Native shared-memory ring + same-host transport tests (native/shm_ring.cc
via ctypes; ref analog: the reference's same-host client/server deployment
still crossing loopback TCPROS, README.md:55-75)."""

import multiprocessing
import os
import tempfile

import numpy as np
import pytest

from corbslam.collab import shm_ring

# NEVER fork from the pytest process: it has initialized XLA (8 CPU devices,
# compiler thread pools), and forked children inheriting that state
# destabilize the PARENT too — the full suite segfaulted inside a later
# XLA:CPU compile until these tests switched to spawn. The children only
# import numpy + the transport modules, so spawn is cheap.
mp = multiprocessing.get_context("spawn")

pytestmark = pytest.mark.skipif(
    not shm_ring.available(), reason="shm ring native lib unavailable")


class TestRing:
    def test_roundtrip_and_order(self):
        r = shm_ring.Ring("/csr_test_rt", 1 << 16, create=True)
        try:
            msgs = [os.urandom(n) for n in (1, 100, 4096, 0, 33)]
            for m in msgs:
                assert r.push(m)
            for m in msgs:
                assert r.pop() == m
            assert r.pop() is None
        finally:
            r.close()

    def test_full_ring_rejects_then_accepts(self):
        r = shm_ring.Ring("/csr_test_full", 1 << 12, create=True)
        try:
            m = b"x" * 1000
            pushed = 0
            while r.push(m):
                pushed += 1
            assert pushed >= 3  # ~4k capacity / ~1k frames
            assert r.pop() == m
            assert r.push(m)  # space reclaimed
        finally:
            r.close()

    def test_oversize_frame_raises(self):
        r = shm_ring.Ring("/csr_test_big", 1 << 12, create=True)
        try:
            with pytest.raises(ValueError):
                r.push(b"y" * (1 << 13))
        finally:
            r.close()

    def test_cross_process(self):
        r = shm_ring.Ring("/csr_test_xp", 1 << 16, create=True)
        p = mp.Process(target=_ring_writer_proc)
        p.start()
        got = []
        import time
        t0 = time.time()
        while len(got) < 50 and time.time() - t0 < 10:
            b = r.pop()
            if b is not None:
                got.append(b)
        p.join()
        r.close()
        assert len(got) == 50
        assert got[10] == bytes([10]) * 11


def _ring_writer_proc():
    w = shm_ring.Ring("/csr_test_xp")
    for i in range(50):
        assert w.push(bytes([i]) * (i + 1))
    # do NOT close: consumer still reading (owner unlink is the parent's)


def _client_proc(session_dir, cid, out_q):
    from corbslam.collab.shm_transport import ShmClientTransport

    t = ShmClientTransport(cid, session_dir, capacity=1 << 20)
    ok = t.call("echo", cid, {"x": np.arange(5, dtype=np.int32) * cid})
    # wait for the broadcast
    import time
    msgs = []
    t0 = time.time()
    while not msgs and time.time() - t0 < 15:
        msgs = t.poll("topicA", cid)
        time.sleep(0.005)
    out_q.put((cid, ok, [np.asarray(m["y"]).tolist() for m in msgs]))
    t.close()


class TestShmTransport:
    def test_call_ack_and_broadcast_across_processes(self):
        from corbslam.collab.shm_transport import ShmServerTransport

        srv = ShmServerTransport(tempfile.mkdtemp(prefix="csr_t_"))
        seen = []
        srv.register_handler(
            "echo", lambda cid, p: seen.append((cid, p["x"].sum())) or True)

        q = mp.Queue()
        procs = [mp.Process(target=_client_proc, args=(srv.session_dir, c, q))
                 for c in (1, 2)]
        for p in procs:
            p.start()
        import time
        t0 = time.time()
        while len(seen) < 2 and time.time() - t0 < 15:
            srv.serve_calls()
            time.sleep(0.005)
        srv.publish("topicA", {"y": np.asarray([7, 8, 9], np.int32)})
        results = [q.get(timeout=15) for _ in procs]
        for p in procs:
            p.join()
        srv.close()

        assert len(seen) == 2
        assert sorted(cid for cid, _, _ in results) == [1, 2]
        for _, ok, msgs in results:
            assert ok
            assert msgs == [[7, 8, 9]]
