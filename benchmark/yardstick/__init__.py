"""The benchmark's yardstick: what the cells measure and judge with.

Nothing here imports the program under test at module level; the program
(`gol_tpu_torch`) is imported inside the functions that drive it.
"""
