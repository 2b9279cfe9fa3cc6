from cuda_fortran_mc_simulation_spin_tpu_torch.models.ising2d import Ising2D  # noqa: F401


def build_model(cfg):
    """RunConfig -> model instance.  The port serves the periodic 2-D
    Ising model; every other model of the JAX package raises, naming the
    ROADMAP.md queue A item that ports it."""
    if cfg.model == "ising2d":
        if cfg.nx % 2 == 1:
            raise NotImplementedError(
                "odd nx selects the helical Ising 2-D engine, not ported "
                "yet (ROADMAP.md queue A item 5)")
        return Ising2D(nx=cfg.nx, ny=cfg.ny, kbt=cfg.kbt)
    items = {"ising3d": 6, "clock": 7, "xy2d": 8}
    if cfg.model in items:
        raise NotImplementedError(
            f"model {cfg.model!r} is not ported yet (ROADMAP.md queue A "
            f"item {items[cfg.model]})")
    raise ValueError(f"unknown model {cfg.model!r}")
