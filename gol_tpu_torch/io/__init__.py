from gol_tpu_torch.io.pgm import (
    input_path,
    output_path,
    read_pgm,
    write_pgm,
)

__all__ = ["input_path", "output_path", "read_pgm", "write_pgm"]
