"""The benchmark's plain reference: plain PyTorch, none of the program.

``core`` holds the pieces; each other module is one chain, with
``run(q, grid, **kwargs) -> dict`` over a (B, Ny, Nx) field and a grid from
:func:`core.latlon_grid`, named by the cells that use it."""
