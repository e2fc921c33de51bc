"""Physical constants (CODATA / CESM shared-constant values).

The port's own copy of `cam_nor_physics_tpu.utils.constants`: the same
plain Python floats, so both packages compute with identical values.
"""

from __future__ import annotations

import math

# --- fundamental ---
AVOGAD = 6.02214e26        # Avogadro's number (molecules/kmole)
BOLTZ = 1.38065e-23        # Boltzmann constant (J/K/molecule)
RGAS = AVOGAD * BOLTZ      # universal gas constant (J/K/kmole)

# --- earth / rotation ---
GRAVIT = 9.80616           # standard gravity (m/s^2)
REARTH = 6.37122e6         # earth radius (m)
OMEGA = 7.292123625e-5     # earth angular velocity (rad/s)
PI = math.pi

# --- dry air & water vapor ---
MWDAIR = 28.966            # molecular weight of dry air (kg/kmole)
MWWV = 18.016              # molecular weight of water vapor (kg/kmole)
RAIR = RGAS / MWDAIR       # dry-air gas constant ~287.04 (J/K/kg)
RH2O = RGAS / MWWV         # water-vapor gas constant ~461.5 (J/K/kg)
ZVIR = RH2O / RAIR - 1.0   # virtual-temperature factor ~0.6078
CPAIR = 1.00464e3          # dry-air specific heat at const p (J/K/kg)
CPWV = 1.810e3             # water-vapor specific heat (J/K/kg)
CPLIQ = 4.188e3            # liquid-water specific heat (J/K/kg)
CPICE = 2.11727e3          # ice specific heat (J/K/kg)
CPVIR = CPWV / CPAIR - 1.0

# --- phase change ---
TMELT = 273.15             # melting point of fresh water (K)
LATVAP = 2.501e6           # latent heat of vaporization (J/kg)
LATICE = 3.337e5           # latent heat of fusion (J/kg)
LATSUB = LATVAP + LATICE   # latent heat of sublimation (J/kg)

# --- reference pressures ---
PSTD = 101325.0            # standard pressure (Pa)
P0 = 1.0e5                 # reference pressure for Exner function (Pa)

# --- misc ---
STEBOL = 5.67e-8           # Stefan-Boltzmann (W/m^2/K^4)
KARMAN = 0.4               # Von Karman constant
RHOH2O = 1.000e3           # density of fresh water (kg/m^3)
EPSILO = MWWV / MWDAIR     # ratio of h2o to dry-air molecular weights ~0.622
CAPPA = RAIR / CPAIR       # R/cp
RHODAIR = PSTD / (RAIR * TMELT)
