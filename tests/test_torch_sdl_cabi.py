"""The port's SDL event ABI pinned against a real C compiler, as
`tests/test_sdl_cabi.py` pins `gol_tpu`'s: `tests/fakesdl.cpp` (a
miniature libSDL2 whose SDL_PollEvent fills a C `SDL_Event` union member
by member) is built with the host's compiler, and the port's
`Window.poll_event` decodes its events through the declared ctypes
structures, which must sit where the C compiler puts the fields and
where `gol_tpu`'s structures sit."""

import ctypes
import os
import shutil
import subprocess

import pytest

import gol_tpu.sdl.window as jwin_mod

import gol_tpu_torch.sdl.window as win_mod
from gol_tpu_torch.sdl.window import Window


@pytest.fixture(scope="module")
def fake_lib(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("cc")
    if cxx is None:
        pytest.skip("no C++ compiler in this environment")
    src = os.path.join(os.path.dirname(__file__), "fakesdl.cpp")
    out = tmp_path_factory.mktemp("fakesdl") / "libfakesdl2.so"
    res = subprocess.run(
        [cxx, "-shared", "-fPIC", "-O1", "-o", str(out), src],
        capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[:400]
    return ctypes.CDLL(str(out))


def test_c_struct_layout_matches_ctypes_decl(fake_lib):
    """The C compiler's offsets for the SDL2 declarations equal the
    port's ctypes structures' (and gol_tpu's): keysym.sym at 20."""
    from gol_tpu_torch.sdl.window import (
        _SDL_Event,
        _SDL_KeyboardEvent,
        _SDL_Keysym,
    )

    c_sym_off = fake_lib.fake_offsetof_sym()
    py_sym_off = _SDL_KeyboardEvent.keysym.offset + _SDL_Keysym.sym.offset
    j_sym_off = (jwin_mod._SDL_KeyboardEvent.keysym.offset
                 + jwin_mod._SDL_Keysym.sym.offset)
    assert c_sym_off == py_sym_off == j_sym_off == 20
    assert ctypes.sizeof(_SDL_Event) >= fake_lib.fake_sizeof_event()
    assert ctypes.sizeof(_SDL_Event) == ctypes.sizeof(jwin_mod._SDL_Event)


def test_poll_event_decodes_c_filled_union(fake_lib, monkeypatch):
    """C code queues keydown and quit events; the port's
    Window.poll_event reads them through the declared union."""
    monkeypatch.setattr(win_mod, "_SDL", fake_lib)
    monkeypatch.delenv("GOL_HEADLESS", raising=False)
    w = Window(16, 16)
    assert w._sdl is fake_lib, "init chain against the C lib failed"
    try:
        for key in "psqk":
            fake_lib.fake_push_key(ord(key))
            assert w.poll_event() == key
        fake_lib.fake_push_key(ord("x"))  # non-control: swallowed
        assert w.poll_event() is None
        fake_lib.fake_push_quit()
        assert w.poll_event() == "quit"
        assert w.poll_event() is None  # drained
        w.set_pixel(3, 3, True)
        w.render_frame()  # the texture path against the C stubs
    finally:
        w.close()
