from gol_tpu_torch.utils.cell import (
    Cell,
    alive_cells_from_board,
    read_alive_cells,
)
from gol_tpu_torch.utils.check import check
from gol_tpu_torch.utils.visualise import alive_cells_to_string, board_diff

__all__ = [
    "Cell",
    "alive_cells_from_board",
    "read_alive_cells",
    "check",
    "alive_cells_to_string",
    "board_diff",
]
