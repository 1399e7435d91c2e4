"""Physical and stoichiometric constants of the BGC/DMS/MACROS model family.

Values reproduce the compile-time PARAMETER constants of the reference
library (citations are reference file:line into E3SM-Project/Ocean-BGC):
BGC_parms.F90:37-44 (time conversions), :327-340 (Redfield ratios),
:371-386 (Fe scavenging), :394-405 (grazing fractions), :411-429 (fixed
quotas), :435-441 (loss thresholds), :447-449 (temp function enums),
:454-463 (PAR fraction, Tref/Q10), :469-489 (DOM remin rates, eps guards,
xkw coefficient); co2calc.F90:41-59 (sea-water density, solver tolerances,
tracer floors).

Everything here is a Python float/int, folded into the CUDA kernels as
immediates.  A copy of ``ocean_bgc_tpu/constants.py``: the port imports
nothing of the JAX package, and tests/test_torch_bridge.py holds every
value here equal to the reference's.
"""

# ---------------------------------------------------------------------------
# time conversions (BGC_parms.F90:37-40)
# ---------------------------------------------------------------------------
SPD = 86400.0                  # seconds per day
DPS = 1.0 / SPD                # days per second
YPS = 1.0 / (365.0 * SPD)      # years per second

# ---------------------------------------------------------------------------
# autotroph functional groups (BGC_parms.F90:42-43, 515-518)
# ---------------------------------------------------------------------------
AUTOTROPH_CNT = 4
SP, DIAT, DIAZ, PHAEO = 0, 1, 2, 3    # canonical group ordering

# temperature-function enums (BGC_parms.F90:447-449)
TFNC_Q10 = 1
TFNC_QUASI_MMRT = 2

# ---------------------------------------------------------------------------
# Redfield ratios, dissolved & particulate (BGC_parms.F90:327-340)
# ---------------------------------------------------------------------------
PARM_RED_D_C_P = 117.0                       # carbon:phosphorus
PARM_RED_D_N_P = 16.0                        # nitrogen:phosphorus
PARM_RED_D_O2_P = 170.0                      # oxygen:phosphorus
PARM_REMIN_D_O2_P = 138.0                    # oxygen:phosphorus (remin)
PARM_RED_P_C_P = PARM_RED_D_C_P
PARM_RED_D_C_N = PARM_RED_D_C_P / PARM_RED_D_N_P
PARM_RED_P_C_N = PARM_RED_D_C_N
PARM_RED_D_C_O2 = PARM_RED_D_C_P / PARM_RED_D_O2_P
PARM_REMIN_D_C_O2 = PARM_RED_D_C_P / PARM_REMIN_D_O2_P
PARM_RED_P_C_O2 = PARM_RED_D_C_O2
PARM_RED_FE_C = 3.0e-6                       # iron:carbon
PARM_RED_D_C_O2_DIAZ = PARM_RED_D_C_P / 150.0  # carbon:oxygen for diazotrophs

# ---------------------------------------------------------------------------
# misc rate constants (BGC_parms.F90:371-386)
# ---------------------------------------------------------------------------
FE_SCAVENGE_THRES1 = 0.8e-3     # upper threshold for Fe scavenging
DUST_FESCAV_SCALE = 1.0e9       # dust scavenging scale factor
FE_MAX_SCALE2 = 1200.0          # unitless scaling coefficient
DUST_TO_FE = 0.035 / 55.847 * 1.0e9   # dust -> iron conversion (nmol Fe/g dust)

# ---------------------------------------------------------------------------
# partitioning of phyto growth / grazing / losses (BGC_parms.F90:394-405)
# ---------------------------------------------------------------------------
CACO3_POC_MIN = 0.4          # min QCaCO3-to-POC-grazing proportionality
SPC_POC_FAC = 0.11           # small-phyto grazing factor (1/mmolC)
F_GRAZE_SP_POC_LIM = 0.3
F_PHOTOSP_CACO3 = 0.4        # sp production -> CaCO3 production cap factor
F_GRAZE_CACO3_REMIN = 0.33   # fraction of grazed spCaCO3 remineralized
F_GRAZE_SI_REMIN = 0.35      # fraction of grazed diatom Si remineralized

# fixed ratios (BGC_parms.F90:411-429)
R_NFIX_PHOTO = 1.25          # N fixation relative to C fixation
Q = 0.137                    # N/C ratio of phyto & zoo (mmol/mmol)
QP_ZOO_POM = 0.00855         # P/C ratio of zoo & POM
QFE_ZOO = 3.0e-6             # zooplankton Fe/C
GQSI_0 = 0.137               # initial Si/C ratio
GQSI_MAX = 0.685             # max Si/C ratio
GQSI_MIN = 0.0457            # min Si/C ratio
QCACO3_MAX = 0.4             # max CaCO3/C
DENITRIF_C_N = PARM_RED_D_C_P / 136.0   # C:N for denitrification

# loss thresholds / CaCO3 bloom parameters (BGC_parms.F90:435-441)
THRES_Z1 = 100.0e2           # cm; full loss threshold above this depth
THRES_Z2 = 150.0e2           # cm; zero threshold below this depth
LOSS_THRES_ZOO = 0.005       # zoo conc. where losses go to zero
CACO3_TEMP_THRES1 = 6.0      # upper temp threshold for CaCO3 production
CACO3_TEMP_THRES2 = -2.0     # lower temp threshold
CACO3_SP_THRES = 4.0         # bloom condition threshold (mmol C/m^3)

# PAR fraction and temperature response (BGC_parms.F90:454-463)
F_QSW_PAR = 0.45             # fraction of shortwave that is PAR
TREF = 30.0                  # reference temperature (C)
Q_10 = 1.5                   # Q10 temperature dependence factor

# DOM remin rates / refractory fractions (BGC_parms.F90:469-477)
DOC_REMINR = (1.0 / 250.0) * DPS          # semi-labile DOC, 1/250 d
DON_REMINR = (1.0 / 160.0) * DPS          # semi-labile DON, 1/160 d
DOFE_REMINR = (1.0 / 160.0) * DPS         # semi-labile DOFe, 1/160 d
DOP_REMINR = (1.0 / 160.0) * DPS          # semi-labile DOP, 1/160 d
DONR_REMINR = (1.0 / (365.0 * 2.5)) * DPS  # refractory DON, 1/2.5 yr
DOPR_REMINR = (1.0 / (365.0 * 2.5)) * DPS  # refractory DOP, 1/2.5 yr
DONREFRACT = 0.08            # fraction of DON to refractory pool
DOPREFRACT = 0.03            # fraction of DOP to refractory pool

# sub-euphotic (PAR_avg <= 1 W/m^2) remin modifications (BGC_mod.F90:1451-1461)
DONR_REMINR_DARK = (1.0 / (365.0 * 670.0)) * DPS   # 1/670 yr
DOPR_REMINR_DARK = (1.0 / (365.0 * 460.0)) * DPS   # 1/460 yr
DOC_REMIN_DARK_FAC = 0.0685
DON_REMIN_DARK_FAC = 0.1
DOFE_REMIN_DARK_FAC = 0.05
DOP_REMIN_DARK_FAC = 0.05

# eps guards (BGC_parms.F90:479-486)
EPSC = 1.00e-8               # small C concentration (mmol C/m^3)
EPSTINV = 3.17e-8            # small inverse time scale (1/yr in 1/s)
EPSNONDIM = 1.00e-6          # small non-dimensional number

# quota-modification constants (BGC_parms.F90:484-486)
CKS = 9.0                    # Fe quota modification constant
CKSI = 5.0                   # Si quota modification constant

# gas exchange (BGC_parms.F90:488-489)
XKW_COEFF = 8.6e-9           # 0.31 cm/hr s^2/m^2 in s/cm

# zero Celsius in Kelvin (host-provided T0_Kelvin_BGC; co2calc.F90:44)
T0_KELVIN = 273.15

# ---------------------------------------------------------------------------
# carbonate solver constants (co2calc.F90:41-59)
# ---------------------------------------------------------------------------
RHO_SW = 1.026               # density of salt water (g/cm^3)
MASS_TO_VOL = 1e6 * RHO_SW   # (mol/kg) -> (mmol/m^3)
VOL_TO_MASS = 1.0 / MASS_TO_VOL
XACC = 1e-10                 # pH solver tolerance
MAX_BRACKET_GROW_IT = 3      # documented bracket-growth cap (soft in reference)
MAXIT = 100                  # pH solver iteration cap
SALT_MIN = 0.1
DIC_MIN = SALT_MIN / 35.0 * 1944.0
ALK_MIN = SALT_MIN / 35.0 * 2225.0
INV_R_GAS = 1.0 / 83.1451    # 1/R in pressure-correction exponent

# pH warm-start window (BGC_mod.F90:144-149)
PHLO_SURF_INIT = 7.0
PHHI_SURF_INIT = 9.0
PHLO_3D_INIT = 6.0
PHHI_3D_INIT = 9.0
DEL_PH = 0.20

# ---------------------------------------------------------------------------
# particulate (ballast) scheme constants (BGC_mod.F90:2046-2069, 2288-2289)
# ---------------------------------------------------------------------------
POC_MASS = 12.01             # molecular weight of POC
P_CACO3_GAMMA = 0.30         # CaCO3 production fraction -> hard subclass
P_CACO3_MASS = 100.09
P_SIO2_GAMMA = 0.030
P_SIO2_MASS = 60.08
DUST_DISS = 20000.0          # dust dissolution length (cm)
DUST_GAMMA = 0.97
DUST_MASS = 1.0e9            # base units are grams
QA_RHO_FAC = 0.05            # QA mass-ratio factor (rho = 0.05*mass/POC mass)
DECAY_HARD_SCALE = 4.0e6     # hard-ballast dissolution length (cm)
DECAY_HARD_DUST_SCALE = 1.2e7  # hard-dust dissolution length (cm)
TFUNCS_Q10 = 1.5             # Q10 for soft-POM remin temperature scaling
FE_SFLUX_REMIN_RATE = 1.5e-5  # sedimentary-style P_iron soft-flux remin (1/cm)
LYSOCLINE_DEPTH = 3300.0e2   # cm; CaCO3 buried above, dissolved below
MPERCM = 0.01                # meters per centimeter

# ---------------------------------------------------------------------------
# DMS module fixed constants (DMS_parms.F90:191-195; DMS_mod.F90:509-533)
# ---------------------------------------------------------------------------
F_QSW_PAR_DMS = 0.45
UV_FRAC_OF_PAR = 0.01        # UV taken as 1% of PAR (DMS_mod.F90:510)
KUV_DOC_COEFF = 0.01e-2      # UV attenuation per DOC (DMS_mod.F90:533)
KUV_BASE = 0.04e-4           # UV attenuation base (DMS_mod.F90:533)
