"""Socket transport: framing, RPC acks, broadcast, multi-client isolation.

The hermetic stand-in for the reference's roscore+TCPROS stack
(corbslam_server/src/main.cpp:49-55, PubToClient.cpp:17-20) — server and
clients run in one process over real localhost sockets.
"""

import threading
import time

import numpy as np
import pytest

from corbslam.collab.socket_transport import (
    SocketClientTransport,
    SocketServerTransport,
)


@pytest.fixture()
def server():
    t = SocketServerTransport()
    t.start()
    yield t
    t.close()


def _serve_background(server, stop):
    while not stop.is_set():
        if server.serve_calls() == 0:
            time.sleep(0.005)


class TestSocketTransport:
    def test_call_round_trip(self, server):
        got = {}

        def handler(cid, payload):
            got["cid"] = cid
            got["x"] = payload["x"]
            return True

        server.register_handler("svc", handler)
        stop = threading.Event()
        th = threading.Thread(target=_serve_background, args=(server, stop),
                              daemon=True)
        th.start()
        c = SocketClientTransport(7, port=server.port)
        x = np.arange(12, dtype=np.float32).reshape(3, 4)
        ok = c.call("svc", 7, {"x": x})
        stop.set()
        assert ok
        assert got["cid"] == 7
        np.testing.assert_array_equal(got["x"], x)
        c.close()

    def test_unknown_service_nacks(self, server):
        stop = threading.Event()
        th = threading.Thread(target=_serve_background, args=(server, stop),
                              daemon=True)
        th.start()
        c = SocketClientTransport(1, port=server.port)
        assert not c.call("nope", 1, {"a": np.zeros(1)})
        stop.set()
        c.close()

    def test_handler_nack_propagates(self, server):
        server.register_handler("svc", lambda cid, p: False)
        stop = threading.Event()
        threading.Thread(target=_serve_background, args=(server, stop),
                         daemon=True).start()
        c = SocketClientTransport(1, port=server.port)
        assert c.call("svc", 1, {"a": np.zeros(3)}) is False
        stop.set()
        c.close()

    def test_broadcast_reaches_all_clients(self, server):
        c1 = SocketClientTransport(1, port=server.port)
        c2 = SocketClientTransport(2, port=server.port)
        deadline = time.time() + 5
        while len(server.clients) < 2 and time.time() < deadline:
            time.sleep(0.01)
        payload = {"v": np.array([1.5, 2.5], np.float32),
                   "ids": np.arange(5, dtype=np.int64)}
        server.publish("topicA", payload)
        deadline = time.time() + 5
        msgs1, msgs2 = [], []
        while time.time() < deadline and (not msgs1 or not msgs2):
            msgs1 = msgs1 or c1.poll("topicA", 1)
            msgs2 = msgs2 or c2.poll("topicA", 2)
            time.sleep(0.01)
        assert len(msgs1) == 1 and len(msgs2) == 1
        np.testing.assert_array_equal(msgs1[0]["ids"], payload["ids"])
        np.testing.assert_allclose(msgs2[0]["v"], payload["v"])
        # Drained queues are empty.
        assert c1.poll("topicA", 1) == []
        c1.close()
        c2.close()

    def test_large_payload(self, server):
        """A full keyframe-chunk-sized message survives framing."""
        seen = {}
        server.register_handler("big", lambda cid, p: (
            seen.update(p), True)[-1])
        stop = threading.Event()
        threading.Thread(target=_serve_background, args=(server, stop),
                         daemon=True).start()
        c = SocketClientTransport(3, port=server.port)
        desc = np.random.default_rng(0).integers(
            0, 255, size=(50, 2048, 32)).astype(np.uint8)
        assert c.call("big", 3, {"desc": desc})
        stop.set()
        np.testing.assert_array_equal(seen["desc"], desc)
        c.close()

    def test_concurrent_clients_get_own_acks(self, server):
        server.register_handler("par", lambda cid, p: cid % 2 == 0)
        stop = threading.Event()
        threading.Thread(target=_serve_background, args=(server, stop),
                         daemon=True).start()
        clients = [SocketClientTransport(i, port=server.port)
                   for i in range(1, 5)]
        results = {}

        def worker(c):
            results[c.cid] = c.call("par", c.cid, {"z": np.zeros(2)})

        ths = [threading.Thread(target=worker, args=(c,)) for c in clients]
        for t in ths:
            t.start()
        for t in ths:
            t.join()
        stop.set()
        assert results == {1: False, 2: True, 3: False, 4: True}
        for c in clients:
            c.close()
