"""The port's Redis annotation queue (``uplink/redis_queue.py``) against the
JAX package's: the same events through either queue leave the same Redis
lists (ready, unacked, rejected, the rmq key scheme) and the same counts
(published, acked, dropped, rejected batches, resumed), and hand the
handler the same batches. Each scenario runs once per package on a fresh
``MiniRedis`` of the port; the heartbeat's value is a timestamp and is
compared by key only. Tolerance: none.
"""

import time

import pytest

from video_edge_ai_proxy_tpu.uplink.redis_queue import RedisAnnotationQueue as JQueue
from video_edge_ai_proxy_tpu_torch.bus.miniredis import MiniRedis
from video_edge_ai_proxy_tpu_torch.bus.resp import RespClient
from video_edge_ai_proxy_tpu_torch.uplink.redis_queue import RedisAnnotationQueue

READY = "rmq::queue::[annotationqueue]::ready"
REJECTED = "rmq::queue::[annotationqueue]::rejected"
QUEUES = {"port": RedisAnnotationQueue, "jax": JQueue}


def events(n, tag=b"e"):
    return [tag + bytes([i]) for i in range(n)]


def batching(make, raw, log):
    q = make(lambda b: log.append(list(b)) or True, max_batch_size=3)
    for e in events(7):
        q.publish(e)
    while q.drain_once():
        pass
    return [q]


def reject_then_requeue(make, raw, log):
    state = {"fail": True}

    def handler(batch):
        log.append(list(batch))
        return not state["fail"]

    q = make(handler, max_batch_size=10)
    for e in events(4):
        q.publish(e)
    q.drain_once()
    state["fail"] = False
    q.requeue_rejected()
    q.drain_once()
    return [q]


def unacked_limit_sheds(make, raw, log):
    q = make(lambda b: log.append(list(b)) or True, unacked_limit=5)
    for e in events(8):
        log.append(q.publish(e))
    return [q]


def handler_raises(make, raw, log):
    def handler(batch):
        log.append(list(batch))
        raise RuntimeError("uplink down")

    q = make(handler)
    for e in events(3):
        q.publish(e)
    log.append(q.drain_once())
    return [q]


def restart_sweeps_unacked(make, raw, log):
    q1 = make(lambda b: True)
    for e in events(5):
        q1.publish(e)
    dead = "rmq::connection::deadProc::queue::[annotationqueue]::unacked"
    raw.command("RPOPLPUSH", READY, dead)
    raw.command("RPOPLPUSH", READY, dead)
    q2 = make(lambda b: log.append(sorted(b)) or True)
    log.append((q2.resumed, q2.depth()))
    q2.drain_once()
    return [q1, q2]


def live_peer_not_stolen(make, raw, log):
    raw.command("LPUSH", READY, b"a", b"b")
    peer = "rmq::connection::peerProc::queue::[annotationqueue]::unacked"
    raw.command("RPOPLPUSH", READY, peer)
    raw.command("SET", "rmq::connection::peerProc::heartbeat", str(int(time.time() * 1000)))
    q = make(lambda b: log.append(sorted(b)) or True)
    log.append((q.resumed, raw.command("LLEN", peer)))
    raw.command("SET", "rmq::connection::peerProc::heartbeat",
                str(int(time.time() * 1000) - 60_000))
    q._last_sweep = float("-inf")
    q.requeue_rejected()
    q.drain_once()
    return [q]


def rejected_survive_restart(make, raw, log):
    q1 = make(lambda b: False)
    for e in events(3):
        q1.publish(e)
    q1.drain_once()
    q2 = make(lambda b: log.append(list(b)) or True, unacked_limit=4)
    log.append((q2.depth(), q2.publish(b"x"), q2.publish(b"y")))
    q2.requeue_rejected()
    while q2.drain_once():
        pass
    return [q1, q2]


def foreign_producer_and_stop(make, raw, log):
    raw.command("LPUSH", READY, b"from-reference")
    q = make(lambda b: log.append(list(b)) or True)
    q.drain_once()
    q.stop()
    log.append(raw.command("EXISTS", "rmq::connection::vepTpu::heartbeat"))
    return [q]


SCENARIOS = {f.__name__: f for f in (batching, reject_then_requeue, unacked_limit_sheds,
                                     handler_raises, restart_sweeps_unacked,
                                     live_peer_not_stolen, rejected_survive_restart,
                                     foreign_producer_and_stop)}


def lists_and_keys(raw):
    out = {}
    for key in sorted(raw.command("KEYS", "*")):
        kind = raw.command("TYPE", key)
        out[key] = raw.command("LRANGE", key, "0", "-1") if kind == "list" else kind
    return out


def run(cls, scenario):
    with MiniRedis() as addr:
        raw = RespClient.from_addr(addr)
        log: list = []
        queues = SCENARIOS[scenario](lambda h, **kw: cls(h, addr=addr, **kw), raw, log)
        counts = [(q.published, q.acked, q.dropped, q.rejected_batches, q.resumed)
                  for q in queues]
        state = lists_and_keys(raw)
        for q in queues:
            q.stop()
        raw.close()
        return log, counts, state


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_both_queues_leave_the_same_entries_and_counts(scenario):
    port, jax_ = run(RedisAnnotationQueue, scenario), run(JQueue, scenario)
    assert port == jax_
    log, counts, state = port
    assert counts and log
    if scenario == "batching":
        assert [len(b) for b in log] == [3, 3, 1] and counts[0][:2] == (7, 7)
    if scenario == "unacked_limit_sheds":
        assert log == [True] * 5 + [False] * 3 and state[READY.encode()][0] == b"e\x04"


def test_the_server_picks_it_for_the_redis_bus(tmp_path):
    from video_edge_ai_proxy_tpu_torch.serve.server import Server
    from video_edge_ai_proxy_tpu_torch.uplink.queue import AnnotationQueue
    from video_edge_ai_proxy_tpu_torch.utils.config import Config

    with MiniRedis() as addr:
        cfg = Config()
        cfg.bus.backend = "redis"
        cfg.bus.redis_addr = addr
        cfg.annotation.endpoint = "http://127.0.0.1:1/annotate"
        srv = Server(cfg, data_dir=str(tmp_path / "redis"))
        try:
            assert isinstance(srv.annotations, RedisAnnotationQueue)
            assert type(srv.bus).__name__ == "RedisFrameBus"
            assert srv.annotations.publish(b"evt") and srv.annotations.depth() == 1
        finally:
            srv.annotations.stop()
            srv.bus.close()
            srv.storage.close()
    cfg = Config()
    cfg.bus.shm_dir = str(tmp_path / "rings")
    srv = Server(cfg, data_dir=str(tmp_path / "shm"))
    try:
        assert type(srv.annotations) is AnnotationQueue
    finally:
        srv.bus.close()
        srv.storage.close()
