"""Physical constants.

Mirrors reference rte/kernels/mo_gas_optics_constants.F90:1-53 (SI units,
CODATA-style values) including the planet-configurable trio (gravity, dry-air
molar mass, dry-air heat capacity) via :func:`init_constants`.
"""
from __future__ import annotations

# Fixed constants
PI = 3.141592653589793

avogad = 6.02214076e23        # Avogadro constant [mol^-1]
boltzmann_k = 1.380649e-23    # Boltzmann constant [J/K]
planck_h = 6.62607015e-34     # Planck constant [J s]
lightspeed = 2.99792458e8     # speed of light [m/s]
stefan_boltzmann = 5.670374419e-8  # [W/m^2/K^4] (2 pi^5 k^4 / (15 h^3 c^2))

m_h2o = 0.018016              # molar mass of water [kg/mol]

# Planet-configurable (Earth defaults); reference allows overriding these for
# other planets (mo_gas_optics_constants.F90:41-49 init_constants).
grav = 9.80665                # gravity at surface [m/s^2]
m_dry = 0.028964              # molar mass of dry air [kg/mol]
cp_dry = 1004.64              # specific heat of dry air [J/kg/K]


def init_constants(gravity: float = 9.80665,
                   molar_mass_dry_air: float = 0.028964,
                   specific_heat_dry_air: float = 1004.64) -> None:
    """Reconfigure planet-dependent constants (reference ``init_constants``)."""
    global grav, m_dry, cp_dry
    grav = gravity
    m_dry = molar_mass_dry_air
    cp_dry = specific_heat_dry_air
