from cuda_fortran_mc_simulation_spin_tpu_torch.models.clock import Clock2D  # noqa: F401
from cuda_fortran_mc_simulation_spin_tpu_torch.models.clock_helical import (  # noqa: F401
    Clock2DHelical,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.models.ising2d import Ising2D  # noqa: F401
from cuda_fortran_mc_simulation_spin_tpu_torch.models.ising2d_helical import (  # noqa: F401
    Ising2DHelical,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.models.ising3d import Ising3D  # noqa: F401
from cuda_fortran_mc_simulation_spin_tpu_torch.models.ising3d_helical import (  # noqa: F401
    Ising3DHelical,
)
from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d import XY2D  # noqa: F401
from cuda_fortran_mc_simulation_spin_tpu_torch.models.xy2d_helical import (  # noqa: F401
    XY2DHelical,
)


def build_model(cfg):
    """RunConfig -> model instance.  The port serves the Ising models:
    periodic 2-D, helical 2-D (odd nx, the reference's committed
    1001x1000), periodic 3-D (even dims) and helical 3-D (odd nx, the
    reference's committed 151x151x150, 501x501x500 and 1001x1000x1000);
    the clock model, periodic (even nx) or helical (odd nx, the
    reference's committed 501x500), every 2 <= q <= 127; and the XY model,
    periodic (even nx) or helical (odd nx, the reference's committed
    10001x10000, any ny)."""
    if cfg.model == "ising2d":
        if cfg.nx % 2 == 1:
            return Ising2DHelical(nx=cfg.nx, ny=cfg.ny, kbt=cfg.kbt)
        return Ising2D(nx=cfg.nx, ny=cfg.ny, kbt=cfg.kbt)
    if cfg.model == "ising3d":
        if cfg.nx % 2 == 1:
            return Ising3DHelical(nx=cfg.nx, ny=cfg.ny, nz=cfg.nz,
                                  kbt=cfg.kbt)
        return Ising3D(nx=cfg.nx, ny=cfg.ny, nz=cfg.nz, kbt=cfg.kbt)
    if cfg.model == "clock":
        if cfg.nx % 2 == 1:
            return Clock2DHelical(nx=cfg.nx, ny=cfg.ny, kbt=cfg.kbt, q=cfg.q)
        return Clock2D(nx=cfg.nx, ny=cfg.ny, kbt=cfg.kbt, q=cfg.q)
    if cfg.model == "xy2d":
        if cfg.nx % 2 == 1:
            return XY2DHelical(nx=cfg.nx, ny=cfg.ny, kbt=cfg.kbt)
        return XY2D(nx=cfg.nx, ny=cfg.ny, kbt=cfg.kbt)
    raise ValueError(f"unknown model {cfg.model!r}")
