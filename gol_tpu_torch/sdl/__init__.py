from gol_tpu_torch.sdl.loop import start
from gol_tpu_torch.sdl.window import Window, sdl_available

__all__ = ["start", "Window", "sdl_available"]
