"""The plain reference that judges the program's output: plain PyTorch and
NumPy, importing nothing of the program (``elastic``: the step;
``problem``: a cell's run worked out from its configuration and draws, and
the comparisons)."""
