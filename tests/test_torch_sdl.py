"""The port's SDL window (`gol_tpu_torch/sdl/window.py`) on a ctypes-stub
fake SDL2, held against `gol_tpu`'s: the counterparts of
`tests/test_sdl.py`. Each case drives the port's `Window` and
`gol_tpu`'s through the same pixel ops and events, and the two must
record equal SDL call sequences (handles read as their values) and equal
texture bytes; the reference's own assertions then hold for the port.
When a real libSDL2 is present, a smoke case runs it under
SDL_VIDEODRIVER=dummy. Tolerance: none."""

import ctypes
import struct

import numpy as np
import pytest

import gol_tpu.sdl.window as jwin_mod

import gol_tpu_torch.sdl.window as win_mod
from gol_tpu_torch.sdl.window import (
    _SDL_KEYDOWN,
    _SDL_PIXELFORMAT_ARGB8888,
    _SDL_QUIT,
    _SDL_TEXTUREACCESS_STREAMING,
)


class FakeFn:
    """Callable attribute standing in for a ctypes foreign function:
    records calls, returns a canned value, tolerates .restype/.argtypes
    assignment like a real ctypes function pointer."""

    def __init__(self, log, name, ret=0, impl=None):
        self._log, self._name, self._ret, self._impl = log, name, ret, impl

    def __call__(self, *args):
        self._log.append((self._name, args))
        if self._impl is not None:
            return self._impl(*args)
        return self._ret


class FakeSDL:
    """Just enough of libSDL2's surface for Window, with an injectable
    event queue for SDL_PollEvent."""

    _RETURNS = {
        "SDL_Init": 0,
        "SDL_CreateWindow": 0xD00D,
        "SDL_CreateRenderer": 0xBEE5,
        "SDL_CreateTexture": 0xF00D,
    }

    def __init__(self):
        self.log = []
        self.pending_events = []
        self._fns = {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        if name not in self._fns:
            impl = self._poll_event if name == "SDL_PollEvent" else None
            self._fns[name] = FakeFn(
                self.log, name, self._RETURNS.get(name, 0), impl)
        return self._fns[name]

    def calls(self, *names):
        return [c for c in self.log if c[0] in names]

    def _poll_event(self, ev_ref):
        if not self.pending_events:
            return 0
        etype, sym = self.pending_events.pop(0)
        # Raw bytes at the SDL2 wire offsets (type at 0, keysym.sym at
        # 20), read back through the declared union.
        buf = ev_ref._obj
        ctypes.memset(ctypes.byref(buf), 0, ctypes.sizeof(buf))
        raw = (ctypes.c_uint8 * ctypes.sizeof(buf)).from_buffer(buf)
        struct.pack_into("<I", raw, 0, etype)
        struct.pack_into("<i", raw, 20, sym)
        return 1


def _norm(arg):
    """A call argument as a comparable value: handles by value, a byref
    event buffer by its type."""
    if isinstance(arg, ctypes.c_void_p):
        return ("ptr", arg.value)
    if type(arg).__name__ == "CArgObject":
        return ("byref", type(arg._obj).__name__)
    return arg


def normalized(log):
    return [(name, tuple(_norm(a) for a in args)) for name, args in log]


@pytest.fixture
def fakes(monkeypatch):
    """(port fake, gol_tpu fake), each installed as its package's
    libSDL2."""
    port, jax = FakeSDL(), FakeSDL()
    monkeypatch.setattr(win_mod, "_SDL", port)
    monkeypatch.setattr(jwin_mod, "_SDL", jax)
    monkeypatch.delenv("GOL_HEADLESS", raising=False)
    return port, jax


def both(fakes, script):
    """Run `script(Window, fake)` for the port and gol_tpu; assert their
    SDL call sequences are equal; return the port's result."""
    port, jax = fakes
    got = script(win_mod.Window, port)
    want = script(jwin_mod.Window, jax)
    assert normalized(port.log) == normalized(jax.log)
    if isinstance(got, bytes):
        assert got == want
    return got


def test_init_sequence_and_texture_params(fakes):
    w = both(fakes, lambda W, f: W(64, 32, scale=4))
    fake = fakes[0]
    names = [n for n, _ in fake.log]
    assert names[:4] == [
        "SDL_Init", "SDL_CreateWindow", "SDL_CreateRenderer",
        "SDL_CreateTexture",
    ]
    _, cw_args = fake.calls("SDL_CreateWindow")[0]
    assert cw_args[0] == b"gol_tpu"
    assert cw_args[3:5] == (64 * 4, 32 * 4)  # scaled window, unscaled board
    _, tex_args = fake.calls("SDL_CreateTexture")[0]
    assert tex_args[1] == _SDL_PIXELFORMAT_ARGB8888
    assert tex_args[2] == _SDL_TEXTUREACCESS_STREAMING
    assert tex_args[3:5] == (64, 32)
    assert w._sdl is fake


def test_render_frame_order_and_pixels(fakes):
    def script(W, fake):
        w = W(8, 4)
        w.set_pixel(2, 1, True)
        w.flip_pixel(7, 3)
        w.flip_pixel(15, 7)  # wraps onto (7, 3): flipped back
        w.flip_pixel(0, 3)
        fake.log.clear()
        w.render_frame()
        return fake.calls("SDL_UpdateTexture")[0][1][2]

    texture = both(fakes, script)
    fake = fakes[0]
    assert [n for n, _ in fake.log] == [
        "SDL_UpdateTexture", "SDL_RenderClear", "SDL_RenderCopy",
        "SDL_RenderPresent",
    ]
    _, up_args = fake.calls("SDL_UpdateTexture")[0]
    assert up_args[3] == 8 * 4  # pitch = width * sizeof(ARGB)
    argb = np.frombuffer(texture, dtype=np.uint32).reshape(4, 8)
    assert argb[1, 2] == 0xFFFFFFFF  # alive -> white
    assert argb[3, 0] == 0xFFFFFFFF
    assert argb[3, 7] == 0xFF000000
    assert argb[0, 0] == 0xFF000000  # dead -> opaque black


def test_poll_event_keysym_offset_decode(fakes):
    def script(W, fake):
        w = W(16, 16)
        got = []
        for key in "psqk":
            fake.pending_events = [(_SDL_KEYDOWN, ord(key))]
            got.append(w.poll_event())
        fake.pending_events = [(_SDL_KEYDOWN, ord("x"))]
        got.append(w.poll_event())  # non-control keys are swallowed
        fake.pending_events = [(_SDL_QUIT, 0)]
        got.append(w.poll_event())  # window close
        got.append(w.poll_event())  # empty queue
        return got

    port, jax = fakes
    got = script(win_mod.Window, port)
    assert got == script(jwin_mod.Window, jax)
    assert got == ["p", "s", "q", "k", None, "quit", None]
    assert normalized(port.log) == normalized(jax.log)


def test_event_structs_match_sdl2_abi():
    """The declared structures reproduce SDL2's layout (sym at byte 20
    of the event) and equal gol_tpu's field for field."""
    from gol_tpu_torch.sdl.window import (
        _SDL_Event,
        _SDL_KeyboardEvent,
        _SDL_Keysym,
    )

    assert _SDL_KeyboardEvent.keysym.offset == 16
    assert _SDL_Keysym.sym.offset == 4
    assert _SDL_Event.key.offset == 0
    assert ctypes.sizeof(_SDL_Event) >= 56  # SDL2's union size
    for ours, theirs in ((_SDL_Keysym, jwin_mod._SDL_Keysym),
                         (_SDL_KeyboardEvent, jwin_mod._SDL_KeyboardEvent),
                         (_SDL_Event, jwin_mod._SDL_Event)):
        assert ctypes.sizeof(ours) == ctypes.sizeof(theirs)
        assert [(n, getattr(ours, n).offset, getattr(ours, n).size)
                for n, _ in ours._fields_] \
            == [(n, getattr(theirs, n).offset, getattr(theirs, n).size)
                for n, _ in theirs._fields_]


def test_close_sequence(fakes):
    def script(W, fake):
        w = W(16, 16)
        fake.log.clear()
        w.close()
        w.close()  # idempotent
        return w

    w = both(fakes, script)
    assert [n for n, _ in fakes[0].log] == ["SDL_DestroyWindow", "SDL_Quit"]
    assert w._sdl is None


def test_headless_env_suppresses_sdl(fakes, monkeypatch):
    monkeypatch.setenv("GOL_HEADLESS", "1")
    w = both(fakes, lambda W, f: W(16, 16))
    assert w._sdl is None and fakes[0].log == []
    assert w.poll_event() is None  # no SDL -> no events, no crash


def test_init_failure_falls_back(fakes):
    for fake in fakes:
        fake._RETURNS = dict(fake._RETURNS, SDL_Init=-1)
    w = both(fakes, lambda W, f: W(16, 16))
    assert w._sdl is None  # failed init -> terminal fallback, not a crash
    assert [n for n, _ in fakes[0].log] == ["SDL_Init"]


def test_create_window_failure_falls_back(fakes):
    for fake in fakes:
        fake._RETURNS = dict(fake._RETURNS, SDL_CreateWindow=0)
    w = both(fakes, lambda W, f: W(16, 16))
    assert w._sdl is None
    assert [n for n, _ in fakes[0].log] == [
        "SDL_Init", "SDL_CreateWindow", "SDL_Quit"]


def test_real_sdl_dummy_driver_smoke(monkeypatch):
    if not win_mod.sdl_available():
        pytest.skip("no real libSDL2 in this image")
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    monkeypatch.delenv("GOL_HEADLESS", raising=False)
    w = win_mod.Window(32, 32)
    try:
        w.flip_pixel(3, 3)
        w.render_frame()
        w.poll_event()
    finally:
        w.close()


class _Tty:
    """A terminal stand-in for sys.stdout: isatty, and the text."""

    def __init__(self):
        self.text = []

    def isatty(self):
        return True

    def write(self, s):
        self.text.append(s)

    def flush(self):
        pass


def test_ansi_frame_equals_jax(monkeypatch):
    """Without SDL the port's window writes gol_tpu's half-block frame
    (cropped to 96 x 160 cells), through the native renderer and through
    the numpy glyph mapping alike."""
    from gol_tpu_torch import native
    from gol_tpu_torch.sdl.window import halfblocks_np

    monkeypatch.setenv("GOL_HEADLESS", "1")
    rng = np.random.default_rng(21)
    for h, w in ((37, 70), (120, 200), (1, 5)):
        board = np.where(rng.random((h, w)) < 0.4, 255, 0).astype(np.uint8)
        texts = []
        for W in (win_mod.Window, jwin_mod.Window, "numpy"):
            tty = _Tty()
            monkeypatch.setattr("sys.stdout", tty)
            if W == "numpy":
                monkeypatch.setattr(native, "render_halfblocks",
                                    lambda p: None)
                W = win_mod.Window
            win = W(w, h)
            win.set_board(board)
            win.flip_pixel(0, 0)
            win.render_frame("Completed Turns 5")
            texts.append("".join(tty.text))
        monkeypatch.undo()
        monkeypatch.setenv("GOL_HEADLESS", "1")
        assert texts[0] == texts[1] == texts[2]
        assert texts[0].endswith("Completed Turns 5\n")
        assert halfblocks_np(board) == native.render_halfblocks(board)
