"""Cross-talk between the two packages' control planes: the port's
`RemoteEngine` and controller against an in-process JAX
`gol_tpu.server.EngineServer` (JAX `Engine` on the CPU mesh), and the JAX
`RemoteEngine` and controller against the port's `EngineServer` over
`Engine(device="cpu")`. The same requests give equal final boards, exact
alive counts at equal turns, equal `GetWorld` frames byte for byte and
equal `GetView` arrays; a quit flag crosses in both directions.
Tolerance: none."""

import os
import queue
import socket
import threading
import time

import numpy as np
import pytest

import gol_tpu
from gol_tpu import events as jev
from gol_tpu import wire as jw
from gol_tpu.client import RemoteEngine as JRemote
from gol_tpu.engine import Engine as JEngine
from gol_tpu.models import parse_rule as jparse_rule
from gol_tpu.ops.reference import run_turns_np
from gol_tpu.server import EngineServer as JServer
import gol_tpu_torch
from gol_tpu_torch import Params, events as ev
from gol_tpu_torch import wire as tw
from gol_tpu_torch.client import RemoteEngine as TRemote
from gol_tpu_torch.engine import FLAG_QUIT, Engine as TEngine
from gol_tpu_torch.models import parse_rule as tparse_rule
from gol_tpu_torch.server import EngineServer as TServer


def _serve(kind, rule="B3/S23"):
    if kind == "jax":
        srv = JServer(port=0, host="127.0.0.1",
                      engine=JEngine(rule=jparse_rule(rule)))
    else:
        srv = TServer(port=0, host="127.0.0.1",
                      engine=TEngine(device="cpu", rule=tparse_rule(rule)))
    srv.start_background()
    return srv


@pytest.fixture
def servers(monkeypatch):
    """{"jax": JAX server, "torch": port server}, torn down after."""
    monkeypatch.setenv("GOL_SERVER_EXIT_ON_KILL", "0")
    made = {}

    def make(rule="B3/S23"):
        made["jax"], made["torch"] = _serve("jax", rule), _serve(
            "torch", rule)
        return made

    yield make
    for srv in made.values():
        srv.shutdown()


def _addr(srv):
    return f"127.0.0.1:{srv.port}"


# Each client is driven against the OTHER package's server.
CROSS = {"torch-client/jax-server": (TRemote, "jax"),
         "jax-client/torch-server": (JRemote, "torch")}


def _board(h, w, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((h, w)) < 0.3).astype(np.uint8) * 255


@pytest.mark.parametrize("size", [16, 64, 512])
@pytest.mark.parametrize("side", ["torch-controller/jax-server",
                                  "jax-controller/torch-server"])
def test_controller_against_the_other_server_matches_golden(
        side, size, servers, images_dir, check_dir, out_dir, monkeypatch):
    srv = servers()["jax" if side.endswith("jax-server") else "torch"]
    monkeypatch.setenv("SER", _addr(srv))
    q = queue.Queue()
    if side.startswith("torch"):
        t = gol_tpu_torch.run(Params(image_width=size, image_height=size,
                                     turns=100), q, images_dir=images_dir,
                              out_dir=out_dir)
        evs, final_t = ev.drain(q), ev.FinalTurnComplete
    else:
        t = gol_tpu.run(gol_tpu.Params(image_width=size, image_height=size,
                                       turns=100), q, None,
                        images_dir=images_dir, out_dir=out_dir)
        evs, final_t = jev.drain(q), jev.FinalTurnComplete
    t.join(60)
    assert not t.is_alive()
    final = [e for e in evs if isinstance(e, final_t)][0]
    assert final.completed_turns == 100
    name = f"{size}x{size}x100.pgm"
    with open(os.path.join(out_dir, name), "rb") as f:
        assert f.read() == (check_dir / "images" / name).read_bytes()


@pytest.mark.parametrize("shape,turns", [((64, 64), 100),
                                         ((512, 512), 40),
                                         ((33, 17), 25)])
def test_equal_final_boards_and_exact_alive_counts(shape, turns, servers):
    s = servers()
    world = _board(*shape, seed=shape[0] * 3 + turns)
    want = run_turns_np((world != 0).astype(np.uint8), turns) * 255
    results = {}
    for name, (client_cls, target) in CROSS.items():
        eng = client_cls(_addr(s[target]))
        eng.ping()  # learn the caps, so the upload is negotiated
        out, turn = eng.server_distributor(
            Params(image_width=shape[1], image_height=shape[0],
                   turns=turns), world)
        assert turn == turns
        np.testing.assert_array_equal(out, want, err_msg=name)
        results[name] = (eng.alive_count(), eng.get_world())
    (a1, (w1, t1)), (a2, (w2, t2)) = results.values()
    assert a1 == a2 == (int((want != 0).sum()), turns)
    assert t1 == t2 == turns
    np.testing.assert_array_equal(w1, w2)


def _raw_get_world(srv, caps):
    """(reply header without its trace context, payload bytes) of one
    GetWorld request that advertises `caps`."""
    s = socket.create_connection(("127.0.0.1", srv.port), timeout=10)
    try:
        jw.send_msg(s, {"method": "GetWorld", "caps": caps})
        header, _ = tw.recv_head_raw(s)
        n = tw.payload_nbytes(header)
        buf = bytearray()
        while len(buf) < n:
            chunk = s.recv(n - len(buf))
            assert chunk
            buf.extend(chunk)
    finally:
        s.close()
    header.pop("tc", None)
    return header, bytes(buf)


@pytest.mark.parametrize("caps", [["packed"], [], ["packed", "zlib"],
                                  ["f32", "packed", "xrle", "zlib"]],
                         ids=["packed", "none", "packed+zlib", "all"])
@pytest.mark.parametrize("rule,shape", [("B3/S23", (64, 64)),
                                        ("B3/S23", (96, 512)),
                                        ("B3/S23", (33, 17)),
                                        ("/2/3", (64, 96))])
def test_get_world_frames_equal_byte_for_byte(rule, shape, caps, servers):
    s = servers(rule)
    if rule == "B3/S23":
        world = _board(*shape, seed=sum(shape))
    else:
        from gol_tpu_torch.models.generations import to_pixels_gen

        rng = np.random.default_rng(5)
        world = to_pixels_gen(rng.choice(np.array([0, 1, 2], np.uint8),
                                         size=shape, p=[0.6, 0.3, 0.1]),
                              tparse_rule(rule))
    p = Params(image_width=shape[1], image_height=shape[0], turns=7)
    TRemote(_addr(s["jax"])).server_distributor(p, world)
    JRemote(_addr(s["torch"])).server_distributor(p, world)
    hj, pj = _raw_get_world(s["jax"], caps)
    ht, pt = _raw_get_world(s["torch"], caps)
    assert ht == hj
    assert pt == pj
    if caps == ["packed"] and rule == "B3/S23":
        assert hj["world"]["codec"] == "packed"
    if not caps:
        assert hj["world"]["codec"] == "u8"


@pytest.mark.parametrize("max_cells", [0, 128, 64 * 64 // 5])
def test_get_view_arrays_equal(max_cells, servers):
    s = servers()
    world = _board(64, 64, seed=1)
    p = Params(image_width=64, image_height=64, turns=12)
    views = {}
    for name, (client_cls, target) in CROSS.items():
        eng = client_cls(_addr(s[target]))
        eng.ping()
        eng.server_distributor(p, world)
        first = eng.get_view(max_cells)
        again = eng.get_view(max_cells)  # an xrle delta against the first
        np.testing.assert_array_equal(again[0], first[0])
        assert again[1:] == first[1:]
        views[name] = first
    (v1, t1, f1), (v2, t2, f2) = views.values()
    assert t1 == t2 == 12 and f1 == f2
    np.testing.assert_array_equal(v1, v2)


@pytest.mark.parametrize("name", CROSS)
def test_cfput_quit_crosses(name, servers, monkeypatch):
    monkeypatch.setenv("GOL_MAX_CHUNK", "4")
    client_cls, target = CROSS[name]
    eng = client_cls(_addr(servers()[target]))
    world = np.zeros((16, 16), dtype=np.uint8)
    world[4:7, 5] = 255  # blinker
    result = {}

    def blocking_run():
        result["out"], result["turn"] = eng.server_distributor(
            Params(threads=1, image_width=16, image_height=16,
                   turns=10**8), world)

    t = threading.Thread(target=blocking_run, daemon=True)
    t.start()
    deadline = time.monotonic() + 30
    while eng.ping() == 0:
        assert time.monotonic() < deadline
        time.sleep(0.05)
    eng.cf_put(FLAG_QUIT)
    t.join(30)
    assert not t.is_alive()
    assert 0 < result["turn"] < 10**8
    assert (result["out"] != 0).sum() == 3
    assert eng.alive_count() == (3, result["turn"])
