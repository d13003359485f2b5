"""Board window: SDL2 when libSDL2 is present, ANSI terminal renderer
otherwise — the counterpart of `gol_tpu/sdl/window.py`.

Counterpart of reference `Local/sdl/window.go:20-82` (cgo → libSDL2: window,
ARGB texture, SetPixel/FlipPixel/RenderFrame/PollEvent). The native path
binds libSDL2 directly via ctypes — same C library, no cgo shim needed —
found with `ctypes.util.find_library("SDL2")` when the first window opens,
not at import. `GOL_HEADLESS=1` suppresses SDL. The fallback renders two
board rows per character line with Unicode half-blocks
(`native.render_halfblocks`, or the same glyphs from numpy when the native
library is absent), giving a live view on any terminal (the reference's
ASCII renderer role, `Local/util/visualise.go`).
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import sys
import threading
from typing import Optional

import numpy as np

_SDL_INIT_VIDEO = 0x20
_SDL_WINDOWPOS_CENTERED = 0x2FFF0000
_SDL_PIXELFORMAT_ARGB8888 = 0x16362004
_SDL_TEXTUREACCESS_STREAMING = 1
_SDL_QUIT = 0x100
_SDL_KEYDOWN = 0x300


class _SDL_Keysym(ctypes.Structure):
    """SDL_Keysym (SDL_keyboard.h): scancode, sym, mod, unused."""

    _fields_ = [
        ("scancode", ctypes.c_int32),
        ("sym", ctypes.c_int32),
        ("mod", ctypes.c_uint16),
        ("unused", ctypes.c_uint32),
    ]


class _SDL_KeyboardEvent(ctypes.Structure):
    """SDL_KeyboardEvent (SDL_events.h). Declared field-by-field so the
    offsets come from the ABI rules, not a hardcoded byte offset (a cast
    of offset 20 of an opaque buffer would break silently on any
    struct-layout change or non-x86 platform)."""

    _fields_ = [
        ("type", ctypes.c_uint32),
        ("timestamp", ctypes.c_uint32),
        ("windowID", ctypes.c_uint32),
        ("state", ctypes.c_uint8),
        ("repeat", ctypes.c_uint8),
        ("padding2", ctypes.c_uint8),
        ("padding3", ctypes.c_uint8),
        ("keysym", _SDL_Keysym),
    ]


class _SDL_Event(ctypes.Union):
    """SDL_Event: the tag + the one member we decode, padded to 64 bytes
    (SDL2's union is 56; the extra headroom is harmless — SDL writes at
    most sizeof(SDL_Event) into the buffer we hand it)."""

    _fields_ = [
        ("type", ctypes.c_uint32),
        ("key", _SDL_KeyboardEvent),
        ("padding", ctypes.c_uint8 * 64),
    ]


_UNLOADED = object()
# libSDL2, None when absent; looked up by the first `_sdl_lib()` call
# (find_library may spawn ldconfig, which an import must not do).
_SDL = _UNLOADED
_sdl_lock = threading.Lock()


def _sdl_lib():
    global _SDL
    with _sdl_lock:
        if _SDL is _UNLOADED:
            name = ctypes.util.find_library("SDL2")
            try:
                _SDL = ctypes.CDLL(name) if name else None
            except OSError:
                _SDL = None
        return _SDL


def sdl_available() -> bool:
    return _sdl_lib() is not None


def halfblocks_np(pixels: np.ndarray) -> str:
    """The half-block frame of a board (nonzero = alive) made with numpy:
    the glyphs and lines `native.render_halfblocks` writes, for when the
    native library is absent."""
    p = np.asarray(pixels) != 0
    if p.shape[0] % 2:
        p = np.vstack([p, np.zeros((1, p.shape[1]), dtype=bool)])
    top, bot = p[0::2], p[1::2]
    glyphs = np.array([" ", "▀", "▄", "█"])
    return "\n".join(
        "".join(row)
        for row in glyphs[top.astype(int) | (bot.astype(int) << 1)]
    ) + "\n"


class Window:
    """FlipPixel/RenderFrame/PollEvent surface over SDL2 or a terminal."""

    def __init__(self, width: int, height: int, scale: int = 1) -> None:
        self.width, self.height = width, height
        self._pixels = np.zeros((height, width), dtype=bool)
        self._sdl = None
        if (os.environ.get("GOL_HEADLESS", "") != "1"
                and _sdl_lib() is not None):
            self._init_sdl(scale)

    # --- pixel ops (reference `window.go:68-82`) --------------------------

    def set_pixel(self, x: int, y: int, alive: bool) -> None:
        self._pixels[y % self.height, x % self.width] = alive

    def flip_pixel(self, x: int, y: int) -> None:
        self._pixels[y % self.height, x % self.width] ^= True

    def set_board(self, board01: np.ndarray) -> None:
        if board01.shape != (self.height, self.width):
            # The SDL render path hands SDL a buffer sized from
            # (height, width); a mismatched board would be a native
            # out-of-bounds read.
            raise ValueError(
                f"board {board01.shape} != window "
                f"({self.height}, {self.width})")
        self._pixels = board01.astype(bool)

    # --- rendering --------------------------------------------------------

    def render_frame(self, status: str = "") -> None:
        if self._sdl is not None:
            self._render_sdl()
        elif sys.stdout.isatty():
            self._render_ansi(status)

    def _render_ansi(self, status: str) -> None:
        from gol_tpu_torch import native

        max_rows = 48 * 2
        max_cols = 160
        p = self._pixels[:max_rows, :max_cols]
        frame = native.render_halfblocks(p.astype(np.uint8) * 255)
        if frame is None:  # no native library: numpy glyph mapping
            frame = halfblocks_np(p)
        sys.stdout.write(
            "\x1b[H\x1b[2J" + frame + status + "\n"
        )
        sys.stdout.flush()

    def poll_event(self) -> Optional[str]:
        """Returns 'q'/'p'/'s'/'k' on keydown, 'quit' on window close.
        Decodes via the declared `_SDL_Event` union — field access, no
        hand-computed offsets (ref contract `Local/sdl/window.go:54-66`)."""
        if self._sdl is None:
            return None
        event = _SDL_Event()
        while self._sdl.SDL_PollEvent(ctypes.byref(event)):
            if event.type == _SDL_QUIT:
                return "quit"
            if event.type == _SDL_KEYDOWN:
                sym = event.key.keysym.sym
                ch = chr(sym) if 0 < sym < 128 else ""
                if ch in "spqk":
                    return ch
        return None

    def close(self) -> None:
        if self._sdl is not None:
            self._sdl.SDL_DestroyWindow(self._win)
            self._sdl.SDL_Quit()
            self._sdl = None

    # --- SDL internals ----------------------------------------------------

    def _init_sdl(self, scale: int) -> None:
        """Bring up window + renderer + texture, or tear everything down
        and leave `_sdl` unset so the ANSI fallback takes over — a
        half-initialized chain (e.g. no usable render driver on a remote
        X display) must not leave a black frozen window."""
        _SDL = _sdl_lib()
        if _SDL.SDL_Init(_SDL_INIT_VIDEO) != 0:
            return
        _SDL.SDL_CreateWindow.restype = ctypes.c_void_p
        self._win = _SDL.SDL_CreateWindow(
            b"gol_tpu",
            _SDL_WINDOWPOS_CENTERED,
            _SDL_WINDOWPOS_CENTERED,
            self.width * scale,
            self.height * scale,
            0,
        )
        if not self._win:
            _SDL.SDL_Quit()
            return
        _SDL.SDL_CreateRenderer.restype = ctypes.c_void_p
        self._ren = _SDL.SDL_CreateRenderer(
            ctypes.c_void_p(self._win), -1, 0
        )
        _SDL.SDL_CreateTexture.restype = ctypes.c_void_p
        self._tex = _SDL.SDL_CreateTexture(
            ctypes.c_void_p(self._ren),
            _SDL_PIXELFORMAT_ARGB8888,
            _SDL_TEXTUREACCESS_STREAMING,
            self.width,
            self.height,
        ) if self._ren else None
        if not self._ren or not self._tex:
            _SDL.SDL_DestroyWindow(ctypes.c_void_p(self._win))
            _SDL.SDL_Quit()
            self._win = self._ren = self._tex = None
            return
        self._sdl = _SDL

    def _render_sdl(self) -> None:
        argb = np.where(
            self._pixels, np.uint32(0xFFFFFFFF), np.uint32(0xFF000000)
        ).astype(np.uint32)
        buf = argb.tobytes()
        self._sdl.SDL_UpdateTexture(
            ctypes.c_void_p(self._tex), None, buf, self.width * 4
        )
        self._sdl.SDL_RenderClear(ctypes.c_void_p(self._ren))
        self._sdl.SDL_RenderCopy(
            ctypes.c_void_p(self._ren), ctypes.c_void_p(self._tex),
            None, None,
        )
        self._sdl.SDL_RenderPresent(ctypes.c_void_p(self._ren))
