"""seg_serve in the port: warm-session serving over the JSON socket protocol,
on the CPU.

The behaviours of tests/test_serve.py, as the port's own tests, with the
real server (accept loop + sockets) in a daemon thread; plus the port's
repair of the prepared-ahead bound (at most ONE request prepared ahead of
the executing one) and one served request whose mask equals the JAX
package's segmentation() on the same phantom and checkpoint.
"""
import json
import os
import socket
import threading
import time

import numpy as np
import pytest
import torch

from phantoms import make_sphere_case
from segmentation3d_tpu.core.seg_infer import segmentation as jax_segmentation
from segmentation3d_tpu.io import read_image as jax_read
from segmentation3d_tpu.utils import model_io as jax_io
from segmentation3d_tpu.utils.normalizer import AdaptiveNormalizer
from segmentation3d_tpu_torch.cli.seg_serve import main as serve_main
from segmentation3d_tpu_torch.core.seg_infer import prepare_cases, segmentation
from segmentation3d_tpu_torch.core.serve import (SegmentationServer, _bind,
                                                 request, serve_forever)
from segmentation3d_tpu_torch.io import Volume, read_image, write_image
from segmentation3d_tpu_torch.models.vnet import SegmentationNet
from segmentation3d_tpu_torch.ops.geometry import Frame
from segmentation3d_tpu_torch.utils import model_io
from segmentation3d_tpu_torch.utils.normalizer import FixedNormalizer
from test_torch_port_checkpoint import KW, seeded_variables


def _wait_for(path, thread, tries=400):
    for _ in range(tries):
        if os.path.exists(path):
            return
        thread.join(0.05)
    assert os.path.exists(path), "the server did not bind"


def _start(server, sock, **kw):
    t = threading.Thread(target=serve_forever, daemon=True,
                         kwargs=dict(server=server, socket_path=sock, log=None, **kw))
    t.start()
    _wait_for(sock, t)
    return t


def _stop(sock, t):
    try:
        request(sock, {"cmd": "shutdown"}, timeout=10)
    except OSError:
        pass
    t.join(10)
    assert not t.is_alive()


def _tiny_model(model_dir, seed=0):
    net = SegmentationNet(1, 2, **KW)
    torch.manual_seed(seed)
    model_io.save_checkpoint(model_dir, 0, 0, net.state_dict(), "vnet", 4, 1, 2,
                             [1.0, 1.0, 1.0], "LINEAR",
                             [FixedNormalizer(mean=0.0, stddev=1.0)],
                             extra={"net_kwargs": dict(KW)})
    return model_dir


def _noise_case(path, shape=(24, 24, 24), seed=3):
    img = np.random.default_rng(seed).normal(0.0, 1.0, shape).astype(np.float32)
    write_image(Volume(img, Frame.identity()), path)
    return path


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """A live server (unix socket) over a tiny model + one noise case."""
    root = tmp_path_factory.mktemp("serve")
    model_dir = _tiny_model(str(root / "model"))
    case = _noise_case(str(root / "case.nii.gz"))

    def run_fn(input_path, output_dir, seg_name, save_image, save_prob):
        return segmentation(input_path, model_dir, output_dir,
                            seg_name=seg_name, save_image=save_image,
                            save_prob=save_prob, batch_size=1,
                            shape_bucket=16, device="cpu")

    server = SegmentationServer(run_fn, model_dir, seg_name="seg.nii.gz")
    sock = str(root / "seg.sock")
    t = _start(server, sock)
    yield root, case, sock, server
    if t.is_alive():
        _stop(sock, t)


def _echo_server(tmpdir, name="h.sock", **kw):
    """A live trivial server on a unix socket; returns (sock_path, thread)."""
    server = SegmentationServer(lambda *a: [], "none")
    sock = os.path.join(str(tmpdir), name)
    return sock, _start(server, sock, **kw)


def test_ping(served):
    _, _, sock, _ = served
    r = request(sock, {"cmd": "ping"})
    assert r["ok"] and r["pong"] and "uptime_s" in r


def test_segment_and_warm_repeat(served):
    root, case, sock, server = served
    r1 = request(sock, {"input": case, "output_dir": str(root / "o1")})
    assert r1["ok"], r1
    assert r1["results"][0][0] == "case"
    out = os.path.join(str(root / "o1"), "case", "seg.nii.gz")
    assert read_image(out).data.shape == (24, 24, 24)
    # warm repeat: same session, new output dir, per-request seg_name
    before = server.served
    r2 = request(sock, {"input": case, "output_dir": str(root / "o2"),
                        "seg_name": "mask.nii.gz"})
    assert r2["ok"], r2
    assert server.served == before + 1
    b = read_image(os.path.join(str(root / "o2"), "case", "mask.nii.gz")).data
    np.testing.assert_array_equal(read_image(out).data, b)


@pytest.mark.parametrize("bad", ["missing_input", "engine_option", "unknown_cmd",
                                 "missing_file"])
def test_per_request_isolation(served, bad):
    """A bad request answers ok=false and the server keeps serving."""
    root, case, sock, _ = served
    req, needle = {
        "missing_input": ({"output_dir": str(root / "bad")}, "input"),
        "engine_option": ({"input": case, "output_dir": str(root / "bad"),
                           "partition_type": "SLAB"}, "partition_type"),
        "unknown_cmd": ({"cmd": "nope"}, "unknown cmd"),
        "missing_file": ({"input": str(root / "missing.nii.gz"),
                          "output_dir": str(root / "bad")}, "Error"),
    }[bad]
    r = request(sock, req)
    assert not r["ok"] and needle in r["error"], r
    assert request(sock, {"cmd": "ping"})["ok"]  # still alive


def test_bad_json_line(served):
    _, _, sock, _ = served
    c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    with c:
        c.connect(sock)
        c.sendall(b"{not json\n")
        line = c.makefile("r").readline()
    r = json.loads(line)
    assert not r["ok"] and "bad JSON" in r["error"]


def test_tcp_mode_and_shutdown():
    """TCP transport: ephemeral port, ping, shutdown ends the accept loop."""
    server = SegmentationServer(lambda *a: [], "none")
    got, ev = {}, threading.Event()

    def ready(addr):
        got["addr"] = addr
        ev.set()

    t = threading.Thread(target=serve_forever, daemon=True,
                         kwargs=dict(server=server, host="127.0.0.1", port=0,
                                     ready=ready, log=None))
    t.start()
    assert ev.wait(10)
    assert request(got["addr"], {"cmd": "ping"})["ok"]
    r = request(got["addr"], {"cmd": "shutdown"})
    assert r["ok"] and r["shutdown"]
    t.join(10)
    assert not t.is_alive()


@pytest.mark.parametrize("idle_timeout", [0.5, 0])
def test_idle_connection(tmp_path, idle_timeout):
    """A connection silent for longer than ``idle_timeout`` is dropped while
    other clients are served; 0 disables the timeout (settimeout(0) would
    be non-blocking and drop every client at once)."""
    sock, t = _echo_server(tmp_path, idle_timeout=idle_timeout)
    try:
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        with c:
            c.settimeout(10)
            c.connect(sock)  # sends nothing for a while
            assert request(sock, {"cmd": "ping"}, timeout=10)["ok"]
            time.sleep(0.8)
            try:
                c.sendall(b'{"cmd": "ping"}\n')
                line = c.makefile("r").readline()
            except OSError:
                line = ""
        if idle_timeout:
            assert line == ""  # dropped
        else:
            assert json.loads(line)["ok"]
    finally:
        _stop(sock, t)


@pytest.mark.parametrize("size,ok", [(64, True), (65, False), (4096, False)])
def test_request_size_cap(tmp_path, size, ok):
    """A payload of EXACTLY max_request_bytes (plus its newline) is served;
    anything longer answers an error and drops the connection instead of
    buffering it."""
    sock, t = _echo_server(tmp_path, max_request_bytes=64)
    try:
        body = '{"cmd": "ping"}'
        line = body + " " * (size - len(body))
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        with c:
            c.settimeout(10)
            c.connect(sock)
            c.sendall(line.encode() + b"\n")
            r = json.loads(c.makefile("r").readline())
        assert r["ok"] == ok, r
        if not ok:
            assert "exceeds" in r["error"]
        assert request(sock, {"cmd": "ping"}, timeout=10)["ok"]  # still alive
    finally:
        _stop(sock, t)


def test_live_socket_not_stolen(tmp_path):
    """A second server refuses to bind over a LIVE server's unix socket; a
    STALE socket file (dead server) is cleaned up and reused."""
    sock, t = _echo_server(tmp_path)
    try:
        with pytest.raises(OSError, match="already listening"):
            _bind(sock, None, None)
        assert request(sock, {"cmd": "ping"}, timeout=10)["ok"]
    finally:
        _stop(sock, t)
    stale = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    stale_path = os.path.join(str(tmp_path), "stale.sock")
    stale.bind(stale_path)
    stale.close()  # closed without listen/accept: connects now fail
    srv, _ = _bind(stale_path, None, None)
    srv.close()
    os.unlink(stale_path)


def _serve_cli(argv, sock):
    t = threading.Thread(target=serve_main, daemon=True, args=(argv,))
    t.start()
    _wait_for(sock, t)
    return t


def test_cli_wiring(tmp_path):
    """seg_serve main() serves on the CPU (-g -1) over a unix socket through
    the real CLI surface; --warmup runs before it listens."""
    model_dir = _tiny_model(str(tmp_path / "model"), seed=1)
    case = _noise_case(str(tmp_path / "c.nii.gz"), shape=(16, 16, 16))
    sock = str(tmp_path / "s.sock")
    t = _serve_cli(["-m", model_dir, "--socket", sock, "-n", "seg.nii.gz",
                    "--batch_size", "1", "-g", "-1", "--warmup", case], sock)
    try:
        r = request(sock, {"input": case, "output_dir": str(tmp_path / "o")})
        assert r["ok"], r
        assert os.path.isfile(str(tmp_path / "o" / "c" / "seg.nii.gz"))
    finally:
        _stop(sock, t)


@pytest.mark.parametrize("argv", [
    ["-m", "x", "-g", "-1"],  # neither --socket nor --port
    ["-m", "x", "--socket", "s", "--port", "1", "-g", "-1"],
    ["-m", "x", "--socket", "s", "--num_devices", "two", "-g", "-1"],
    ["-m", "x", "--fine_model", "y", "--socket", "s", "--spatial_shard",
     "--num_devices", "2", "--partition_type", "SLAB", "-g", "-1"],
    ["-m", "x", "--fine_model", "y", "--socket", "s", "--spatial_shard", "-g", "-1"],
    ["-m", "x", "--fine_model", "y", "--socket", "s", "--checkpoint", "best", "-g", "-1"],
    ["-m", "x", "-m", "z", "--fine_model", "y", "--socket", "s", "-g", "-1"],
])
def test_cli_refuses(argv):
    with pytest.raises(SystemExit):
        serve_main(argv)


@pytest.mark.parametrize("extra", [["--num_devices", "3"], ["--num_devices", "-1"],
                                   ["--num_devices", "2", "--spatial_shard",
                                    "--partition_type", "SLAB"]])
def test_cli_passes_shard_options(extra, monkeypatch, tmp_path):
    """``--num_devices`` and ``--spatial_shard`` reach each request's
    segmentation() as the JAX server hands them on: the server's devices,
    chosen once at start (on the CPU, one shard per device asked for; -1
    counts the CPU once), and the same spatial_shard."""
    import segmentation3d_tpu.cli.seg_serve as jax_serve
    import segmentation3d_tpu_torch.cli.seg_serve as port_serve
    calls, servers = {}, {}
    for tag, mod in (("jax", jax_serve), ("port", port_serve)):
        monkeypatch.setattr(mod, "segmentation", lambda tag=tag, **kw: calls.update({tag: kw}))
        monkeypatch.setattr(mod, "serve_forever",
                            lambda server, tag=tag, **kw: servers.update({tag: server}))
    argv = ["-m", str(tmp_path), "--socket", str(tmp_path / "s.sock")] + extra
    jax_serve.main(argv)
    port_serve.main(argv + ["-g", "-1"])
    for server in servers.values():
        server.run_fn("in.nii.gz", "out", "seg.mha", False, False)
    n = int(extra[1])
    assert calls["port"]["device"] == [torch.device("cpu")] * (1 if n < 0 else n)
    assert calls["jax"]["num_devices"] == n
    assert calls["port"]["spatial_shard"] == calls["jax"]["spatial_shard"]


def test_cli_needs_a_card_or_the_cpu(tmp_path):
    """Without -g -1 it serves on cuda:0, and raises where there is none."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(["-m", str(tmp_path), "--socket", str(tmp_path / "s.sock")])
    assert not os.path.exists(str(tmp_path / "s.sock"))


def test_serve_coarse_to_fine_wiring(tmp_path):
    """--fine_model serves the coarse-to-fine pipeline (save_prob and --post
    pass through; probabilities are a distribution everywhere)."""
    model_dir = _tiny_model(str(tmp_path / "model"), seed=2)
    case = _noise_case(str(tmp_path / "c.nii.gz"), seed=0)
    sock = str(tmp_path / "c2f.sock")
    t = _serve_cli(["-m", model_dir, "--fine_model", model_dir, "--socket", sock,
                    "-n", "seg.nii.gz", "--partition_size", "16", "16", "16",
                    "--batch_size", "1", "--post", "largest_cc", "-g", "-1"], sock)
    try:
        r = request(sock, {"input": case, "output_dir": str(tmp_path / "o"),
                           "save_prob": True}, timeout=300)
        assert r["ok"], r
        out_dir = str(tmp_path / "o" / "c")
        assert os.path.isfile(os.path.join(out_dir, "seg.nii.gz"))
        p0, p1 = (read_image(os.path.join(out_dir, f"prob_{c}.mha")).data
                  for c in (0, 1))
        np.testing.assert_allclose(p0 + p1, 1.0, atol=0.05)
    finally:
        _stop(sock, t)


# ---------------------------------------------------------------------------
# request pipelining: prep of the next queued request overlaps the current
# one's execution; execution stays single-flight FIFO with per-request
# isolation, and at most one request is prepared ahead
# ---------------------------------------------------------------------------


def _pipelined_server(tmp_path, run_fn, prep_fn):
    server = SegmentationServer(run_fn, "fake")
    sock = str(tmp_path / "p.sock")
    return server, sock, _start(server, sock, prep_fn=prep_fn)


def _burst(sock, tmp_path, n, gap=0.05):
    """``n`` requests from ``n`` client threads, staggered so that arrival
    (and FIFO) order is deterministic; returns the responses and the wall."""
    results = [None] * n

    def client(i):
        results[i] = request(sock, {"input": f"in{i}", "output_dir": str(tmp_path)})
    t0 = time.time()
    threads = []
    for i in range(n):
        th = threading.Thread(target=client, args=(i,))
        th.start()
        threads.append(th)
        time.sleep(gap)
    for th in threads:
        th.join(15)
    assert all(r is not None and r["ok"] for r in results), results
    return results, time.time() - t0


def test_burst_overlaps_prep_with_execution(tmp_path):
    """3 requests with prep 0.4 s (host) and run 0.4 s (device): pipelined
    wall is ~prep + 3 x run, well under the serial 3 x (prep + run)."""
    events = []

    def prep_fn(req):
        time.sleep(0.4)
        events.append(("prep", req["input"]))
        return f"prepared:{req['input']}"

    def run_fn(input_path, output_dir, seg_name, save_image, save_prob,
               prepared=None):
        assert prepared == f"prepared:{input_path}"
        time.sleep(0.4)
        events.append(("run", input_path))
        return [(input_path, 0.4)]

    _, sock, t = _pipelined_server(tmp_path, run_fn, prep_fn)
    try:
        _, wall = _burst(sock, tmp_path, 3)
        # serial would be >= 3 * 0.8 = 2.4; pipelined ~0.4 + 3 * 0.4 = 1.6
        assert wall < 2.1, f"burst took {wall:.2f}s — prep did not overlap"
        assert [e[1] for e in events if e[0] == "run"] == ["in0", "in1", "in2"]
    finally:
        _stop(sock, t)


def test_at_most_one_request_prepared_ahead(tmp_path):
    """However long the queue, a request is prepared only once the one
    before it started executing: at most one prepared request waits (the
    JAX package's server lets two wait)."""
    lock = threading.Lock()
    state = {"waiting": 0, "max_waiting": 0, "running": False}

    def prep_fn(req):
        with lock:
            state["waiting"] += 1
            state["max_waiting"] = max(state["max_waiting"], state["waiting"])
        return req["input"]

    def run_fn(input_path, output_dir, seg_name, save_image, save_prob,
               prepared=None):
        with lock:
            state["waiting"] -= 1
        time.sleep(0.25)
        return [(prepared, 0.25)]

    _, sock, t = _pipelined_server(tmp_path, run_fn, prep_fn)
    try:
        results, _ = _burst(sock, tmp_path, 5, gap=0.02)
        assert [r["results"][0][0] for r in results] == [f"in{i}" for i in range(5)]
        assert state["waiting"] == 0
        assert state["max_waiting"] == 1, state
    finally:
        _stop(sock, t)


def test_ordering_and_isolation_same_connection(tmp_path):
    """Several requests on ONE connection answer in order even when one in
    the middle fails (per-request isolation under overlap)."""
    def prep_fn(req):
        if req["input"] == "bad-prep":
            raise RuntimeError("prep exploded")
        return "ok"

    def run_fn(input_path, output_dir, seg_name, save_image, save_prob,
               prepared=None):
        if input_path == "bad-run":
            raise RuntimeError("run exploded")
        return [(input_path, 0.0)]

    _, sock, t = _pipelined_server(tmp_path, run_fn, prep_fn)
    try:
        c = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        with c:
            c.connect(sock)
            c.sendall(b"".join(
                json.dumps({"input": name, "output_dir": str(tmp_path)}).encode() + b"\n"
                for name in ["a", "bad-prep", "bad-run", "b"]))
            rf = c.makefile("r")
            lines = [json.loads(rf.readline()) for _ in range(4)]
        assert lines[0]["ok"] and lines[0]["results"][0][0] == "a"
        assert not lines[1]["ok"] and "prep exploded" in lines[1]["error"]
        assert not lines[2]["ok"] and "run exploded" in lines[2]["error"]
        assert lines[3]["ok"] and lines[3]["results"][0][0] == "b"
    finally:
        _stop(sock, t)


def test_ping_immediate_during_long_request(tmp_path):
    """A health-check ping answers while a segmentation runs."""
    gate, started = threading.Event(), threading.Event()

    def run_fn(input_path, output_dir, seg_name, save_image, save_prob,
               prepared=None):
        started.set()
        gate.wait(10)
        return [(input_path, 0.0)]

    _, sock, t = _pipelined_server(tmp_path, run_fn, None)
    try:
        resp = [None]

        def client():
            resp[0] = request(sock, {"input": "x", "output_dir": str(tmp_path)})
        th = threading.Thread(target=client)
        th.start()
        assert started.wait(10)  # the request is executing (blocked on gate)
        t0 = time.time()
        r = request(sock, {"cmd": "ping"}, timeout=5)
        assert r["ok"] and r["pong"]
        assert time.time() - t0 < 2.0
        assert resp[0] is None  # answered before the request ended
        gate.set()
        th.join(10)
        assert resp[0]["ok"]
    finally:
        gate.set()
        _stop(sock, t)


def test_shutdown_queues_fifo_behind_requests(tmp_path):
    """Requests sent before shutdown still run; the server exits after."""
    ran = []

    def run_fn(input_path, output_dir, seg_name, save_image, save_prob,
               prepared=None):
        time.sleep(0.2)
        ran.append(input_path)
        return [(input_path, 0.2)]

    _, sock, t = _pipelined_server(tmp_path, run_fn, None)
    results = [None, None]

    def client(i):
        results[i] = request(sock, {"input": f"q{i}", "output_dir": str(tmp_path)})
    ths = []
    for i in range(2):
        th = threading.Thread(target=client, args=(i,))
        th.start()
        ths.append(th)
        time.sleep(0.05)
    time.sleep(0.05)
    r = request(sock, {"cmd": "shutdown"}, timeout=10)
    assert r["ok"] and r.get("shutdown")
    for th in ths:
        th.join(10)
    t.join(10)
    assert not t.is_alive()
    assert ran == ["q0", "q1"]
    assert all(x is not None and x["ok"] for x in results), results


def test_prepared_input_drives_real_segmentation(served, tmp_path):
    """prepare_cases -> segmentation(prepared=...) is the call path of the
    serving prep stage: results match the unprepared call; a mismatched
    input raises and closes the prepared read-ahead."""
    _, case, _, server = served
    model_dir = server.model_dir
    kw = dict(seg_name="seg.nii.gz", batch_size=1, shape_bucket=16, device="cpu")
    r1 = segmentation(case, model_dir, str(tmp_path / "p1"),
                      prepared=prepare_cases(case, device="cpu"), **kw)
    r2 = segmentation(case, model_dir, str(tmp_path / "p2"), **kw)
    a = read_image(str(tmp_path / "p1" / r1[0][0] / "seg.nii.gz")).data
    b = read_image(str(tmp_path / "p2" / r2[0][0] / "seg.nii.gz")).data
    np.testing.assert_array_equal(a, b)
    prep = prepare_cases(case, device="cpu")
    with pytest.raises(ValueError, match="prepared input"):
        segmentation("other.nii.gz", model_dir, str(tmp_path / "p3"),
                     prepared=prep, **kw)
    prep.reader._ut.join(10)
    assert not prep.reader._ut.is_alive() and not prep.reader._dt.is_alive()


def test_served_mask_equals_jax_segmentation(tmp_path):
    """One request through the port's server (seg_serve -g -1) on a
    JAX-written checkpoint and a phantom: the mask is the JAX package's
    segmentation() mask (identical, or >= 99.9% with every differing voxel
    an argmax near-tie in JAX's probabilities, as in
    tests/test_torch_port_seg_infer.py)."""
    d = str(tmp_path)
    imgs, _ = make_sphere_case(d, "case", shape_zyx=(30, 34, 28),
                               spacing=(1.1, 0.9, 1.3))
    v, _ = seeded_variables(seed=4)
    model_dir = os.path.join(d, "model")
    jax_io.save_checkpoint(model_dir, 1, 0, v, "vnet", 4, 1, 2, [1.0, 1.0, 1.0],
                           "LINEAR", [AdaptiveNormalizer()],
                           extra={"net_kwargs": dict(KW)})
    jax_segmentation(imgs[0], model_dir, os.path.join(d, "jax"), save_prob=True)
    sock = os.path.join(d, "j.sock")
    t = _serve_cli(["-m", model_dir, "--socket", sock, "-g", "-1"], sock)
    try:
        r = request(sock, {"input": imgs[0], "output_dir": os.path.join(d, "port")})
        assert r["ok"] and r["results"][0][0] == "case_mod0", r
    finally:
        _stop(sock, t)
    ref = jax_read(os.path.join(d, "jax", "case_mod0", "seg.mha")).data
    got = jax_read(os.path.join(d, "port", "case_mod0", "seg.mha")).data
    assert got.shape == ref.shape == (30, 34, 28)
    assert 0.05 < np.mean(ref == 1) < 0.95  # both labels present
    differ = got != ref
    assert differ.mean() <= 1e-3
    p0, p1 = (jax_read(os.path.join(d, "jax", "case_mod0", f"prob_{c}.mha")).data
              for c in (0, 1))
    assert np.all(np.abs(p0 - p1)[differ] < 1e-4 + 2.0 ** -11)
