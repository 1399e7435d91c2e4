"""Diagnostics registry: name, shape-kind, units, description per field.

A copy of ``ocean_bgc_tpu/utils/diag.py`` (the port imports nothing of the
JAX package; ``tests/test_torch_bridge.py`` holds the two registries
equal).  The reference's diagnostics structs are its observability
system: ~95 BGC + 14 BGC-flux + 27 DMS + 8 DMS-flux + 6 MACROS named
fields with short/long names and units registered at init
(BGC_mod.F90:221-328 et al.).  This module is the registry of the
diagnostics dicts the port's step returns.

Shape kinds: "level" (nlev, ncol), "level_auto" (nlev, nauto, ncol),
"column" (ncol,), "column_auto" (nauto, ncol), "tracer" (ntracer, ncol).
"""

from __future__ import annotations

from typing import Dict, NamedTuple


class DiagSpec(NamedTuple):
    kind: str
    units: str
    description: str


_L = "level"
_LA = "level_auto"
_C = "column"
_CA = "column_auto"

_RATE = "mmol/m^3/s"
_CONC = "mmol/m^3"
_FLUX = "mmol/m^3 cm/s"

BGC_DIAGS: Dict[str, DiagSpec] = {
    # carbonate system
    "CO3": DiagSpec(_L, _CONC, "carbonate ion"),
    "HCO3": DiagSpec(_L, _CONC, "bicarbonate ion"),
    "H2CO3": DiagSpec(_L, _CONC, "carbonic acid"),
    "pH_3D": DiagSpec(_L, "pH", "3D pH (total scale)"),
    "CO3_ALT_CO2": DiagSpec(_L, _CONC, "carbonate ion, alternative CO2"),
    "HCO3_ALT_CO2": DiagSpec(_L, _CONC, "bicarbonate ion, alternative CO2"),
    "H2CO3_ALT_CO2": DiagSpec(_L, _CONC, "carbonic acid, alternative CO2"),
    "pH_3D_ALT_CO2": DiagSpec(_L, "pH", "3D pH, alternative CO2"),
    "co3_sat_calc": DiagSpec(_L, _CONC, "CO3 at calcite saturation"),
    "co3_sat_arag": DiagSpec(_L, _CONC, "CO3 at aragonite saturation"),
    # nitrogen / nutrient cycling
    "NO3_RESTORE": DiagSpec(_L, _RATE, "NO3 restoring tendency"),
    "SiO3_RESTORE": DiagSpec(_L, _RATE, "SiO3 restoring tendency"),
    "PO4_RESTORE": DiagSpec(_L, _RATE, "PO4 restoring tendency"),
    "NITRIF": DiagSpec(_L, _RATE, "nitrification NH4->NO3"),
    "DENITRIF": DiagSpec(_L, _RATE, "water-column denitrification"),
    "tot_Nfix": DiagSpec(_L, _RATE, "total N fixation"),
    # oxygen
    "O2_PRODUCTION": DiagSpec(_L, _RATE, "photosynthetic O2 production"),
    "O2_CONSUMPTION": DiagSpec(_L, _RATE, "respiratory O2 consumption"),
    "AOU": DiagSpec(_L, _CONC, "apparent oxygen utilization"),
    # light & grazing
    "PAR_avg": DiagSpec(_L, "W/m^2", "cell-average PAR"),
    "zoo_loss": DiagSpec(_L, _RATE, "zooplankton loss"),
    "auto_graze_TOT": DiagSpec(_L, _RATE, "total autotroph grazing"),
    "photoC_TOT": DiagSpec(_L, _RATE, "total C fixation"),
    "photoC_NO3_TOT": DiagSpec(_L, _RATE, "total C fixation from NO3"),
    "tot_CaCO3_form": DiagSpec(_L, _RATE, "total CaCO3 formation"),
    # DOM cycling
    "DOC_prod": DiagSpec(_L, _RATE, "DOC production"),
    "DOC_remin": DiagSpec(_L, _RATE, "DOC remineralization"),
    "DON_prod": DiagSpec(_L, _RATE, "DON production"),
    "DON_remin": DiagSpec(_L, _RATE, "DON remineralization"),
    "DOP_prod": DiagSpec(_L, _RATE, "DOP production"),
    "DOP_remin": DiagSpec(_L, _RATE, "DOP remineralization"),
    "DOFe_prod": DiagSpec(_L, _RATE, "DOFe production"),
    "DOFe_remin": DiagSpec(_L, _RATE, "DOFe remineralization"),
    "DONr_remin": DiagSpec(_L, _RATE, "refractory DON remineralization"),
    "DOPr_remin": DiagSpec(_L, _RATE, "refractory DOP remineralization"),
    # iron
    "Fe_scavenge": DiagSpec(_L, _RATE, "dissolved iron scavenging"),
    "Fe_scavenge_rate": DiagSpec(_L, "1/y", "iron scavenging rate"),
    # particulates
    "POC_FLUX_IN": DiagSpec(_L, _FLUX, "POC flux into cell"),
    "POC_PROD": DiagSpec(_L, _RATE, "POC production"),
    "POC_ACCUM": DiagSpec(_L, _RATE, "POC accumulation (declared but never "
                                     "assigned in the reference; always 0)"),
    "POC_REMIN": DiagSpec(_L, _RATE, "POC remineralization"),
    "CaCO3_FLUX_IN": DiagSpec(_L, _FLUX, "CaCO3 flux into cell"),
    "CaCO3_PROD": DiagSpec(_L, _RATE, "CaCO3 production"),
    "CaCO3_REMIN": DiagSpec(_L, _RATE, "CaCO3 remineralization"),
    "SiO2_FLUX_IN": DiagSpec(_L, _FLUX, "SiO2 flux into cell"),
    "SiO2_PROD": DiagSpec(_L, _RATE, "SiO2 production"),
    "SiO2_REMIN": DiagSpec(_L, _RATE, "SiO2 remineralization"),
    "dust_FLUX_IN": DiagSpec(_L, "g/cm^2/s", "dust flux into cell"),
    "dust_REMIN": DiagSpec(_L, "g/cm^3/s", "dust remineralization"),
    "P_iron_FLUX_IN": DiagSpec(_L, _FLUX, "particulate Fe flux into cell"),
    "P_iron_PROD": DiagSpec(_L, _RATE, "particulate Fe production"),
    "P_iron_REMIN": DiagSpec(_L, _RATE, "particulate Fe remineralization"),
    "calcToSed": DiagSpec(_L, _FLUX, "CaCO3 burial to sediments"),
    "bsiToSed": DiagSpec(_L, _FLUX, "bSi burial to sediments"),
    "pocToSed": DiagSpec(_L, _FLUX, "POC burial to sediments"),
    "ponToSed": DiagSpec(_L, _FLUX, "PON burial to sediments"),
    "popToSed": DiagSpec(_L, _FLUX, "POP burial to sediments"),
    "dustToSed": DiagSpec(_L, "g/cm^2/s", "dust burial to sediments"),
    "pfeToSed": DiagSpec(_L, _FLUX, "particulate Fe burial to sediments"),
    "SedDenitrif": DiagSpec(_L, _FLUX, "sedimentary denitrification"),
    "OtherRemin": DiagSpec(_L, _FLUX, "non-oxic non-denitrif sediment "
                                      "remineralization"),
    # per-autotroph
    "N_lim": DiagSpec(_LA, "1", "N limitation factor"),
    "P_lim": DiagSpec(_LA, "1", "P limitation factor"),
    "Fe_lim": DiagSpec(_LA, "1", "Fe limitation factor"),
    "SiO3_lim": DiagSpec(_LA, "1", "SiO3 limitation factor"),
    "light_lim": DiagSpec(_LA, "1", "light limitation factor"),
    "photoC": DiagSpec(_LA, _RATE, "C fixation"),
    "photoC_NO3": DiagSpec(_LA, _RATE, "C fixation from NO3"),
    "photoFe": DiagSpec(_LA, _RATE, "Fe uptake"),
    "photoNO3": DiagSpec(_LA, _RATE, "NO3 uptake"),
    "photoNH4": DiagSpec(_LA, _RATE, "NH4 uptake"),
    "PO4_uptake": DiagSpec(_LA, _RATE, "PO4 uptake"),
    "DOP_uptake": DiagSpec(_LA, _RATE, "DOP uptake"),
    "auto_graze": DiagSpec(_LA, _RATE, "autotroph grazing"),
    "auto_loss": DiagSpec(_LA, _RATE, "autotroph non-grazing mortality"),
    "auto_agg": DiagSpec(_LA, _RATE, "autotroph aggregation"),
    "bSi_form": DiagSpec(_LA, _RATE, "biogenic Si formation"),
    "CaCO3_form": DiagSpec(_LA, _RATE, "CaCO3 formation"),
    "Nfix": DiagSpec(_LA, _RATE, "N fixation"),
    # vertical integrals / column scalars
    "photoC_zint": DiagSpec(_CA, "mmol/m^3 cm/s", "C fixation integral"),
    "photoC_NO3_zint": DiagSpec(_CA, "mmol/m^3 cm/s",
                                "NO3-fuelled C fixation integral"),
    "CaCO3_form_zint": DiagSpec(_CA, "mmol/m^3 cm/s",
                                "CaCO3 formation integral"),
    "photoC_TOT_zint": DiagSpec(_C, "mmol/m^3 cm/s",
                                "total C fixation integral"),
    "photoC_NO3_TOT_zint": DiagSpec(_C, "mmol/m^3 cm/s",
                                    "total NO3 C fixation integral"),
    "tot_CaCO3_form_zint": DiagSpec(_C, "mmol/m^3 cm/s",
                                    "total CaCO3 formation integral"),
    "tot_bSi_form": DiagSpec(_C, _RATE, "total bSi formation"),
    "Chl_TOT_zint_100m": DiagSpec(_C, "mg/m^3 cm",
                                  "0-100m chlorophyll integral"),
    "Jint_Ctot": DiagSpec(_C, "mmol/m^3 cm/s", "C conservation residual"),
    "Jint_100m_Ctot": DiagSpec(_C, "mmol/m^3 cm/s",
                               "C conservation residual, 0-100m"),
    "Jint_Ntot": DiagSpec(_C, "mmol/m^3 cm/s", "N conservation residual"),
    "Jint_100m_Ntot": DiagSpec(_C, "mmol/m^3 cm/s",
                               "N conservation residual, 0-100m"),
    "Jint_Ptot": DiagSpec(_C, "mmol/m^3 cm/s", "P conservation residual"),
    "Jint_100m_Ptot": DiagSpec(_C, "mmol/m^3 cm/s",
                               "P conservation residual, 0-100m"),
    "Jint_Sitot": DiagSpec(_C, "mmol/m^3 cm/s", "Si conservation residual"),
    "Jint_100m_Sitot": DiagSpec(_C, "mmol/m^3 cm/s",
                                "Si conservation residual, 0-100m"),
    "zsatcalc": DiagSpec(_C, "cm", "calcite saturation depth"),
    "zsatarag": DiagSpec(_C, "cm", "aragonite saturation depth"),
    "O2_ZMIN": DiagSpec(_C, _CONC, "vertical O2 minimum"),
    "O2_ZMIN_DEPTH": DiagSpec(_C, "cm", "depth of O2 minimum"),
}

BGC_FLUX_DIAGS: Dict[str, DiagSpec] = {
    "pistonVel_O2": DiagSpec(_C, "cm/s", "O2 piston velocity"),
    "SCHMIDT_O2": DiagSpec(_C, "1", "O2 Schmidt number"),
    "O2SAT": DiagSpec(_C, _CONC, "O2 saturation concentration"),
    "xkw": DiagSpec(_C, "cm/s", "ice-weighted gas transfer velocity"),
    "co2star": DiagSpec(_C, _CONC, "CO2*"),
    "dco2star": DiagSpec(_C, _CONC, "delta CO2*"),
    "pco2surf": DiagSpec(_C, "ppmv", "oceanic pCO2"),
    "dpco2": DiagSpec(_C, "ppmv", "delta pCO2"),
    "pistonVel_CO2": DiagSpec(_C, "cm/s", "CO2 piston velocity"),
    "SCHMIDT_CO2": DiagSpec(_C, "1", "CO2 Schmidt number"),
    "co2star_alt_co2": DiagSpec(_C, _CONC, "CO2*, alternative CO2"),
    "dco2star_alt_co2": DiagSpec(_C, _CONC, "delta CO2*, alternative CO2"),
    "pco2surf_alt_co2": DiagSpec(_C, "ppmv", "oceanic pCO2, alternative"),
    "dpco2_alt_co2": DiagSpec(_C, "ppmv", "delta pCO2, alternative"),
    "netFlux": DiagSpec("tracer", _FLUX, "net surface flux per tracer"),
}

_S_RATE = "mmol S/m^3/s"
DMS_DIAGS: Dict[str, DiagSpec] = {
    "DMS_S_DMSP": DiagSpec(_L, _S_RATE, "DMS source from DMSP conversion"),
    "DMS_S_TOTAL": DiagSpec(_L, _S_RATE, "DMS source total"),
    "DMS_R_B": DiagSpec(_L, _S_RATE, "DMS removal by bacteria"),
    "DMS_R_PHOT": DiagSpec(_L, _S_RATE, "DMS removal by photolysis"),
    "DMS_R_BKGND": DiagSpec(_L, _S_RATE, "DMS background removal"),
    "DMS_R_TOTAL": DiagSpec(_L, _S_RATE, "DMS removal total"),
    "DMSP_S_PHAEO": DiagSpec(_L, _S_RATE, "DMSP source from Phaeocystis"),
    "DMSP_S_NONPHAEO": DiagSpec(_L, _S_RATE, "DMSP source, other phyto"),
    "DMSP_S_ZOO": DiagSpec(_L, _S_RATE, "DMSP source from zooplankton"),
    "DMSP_S_TOTAL": DiagSpec(_L, _S_RATE, "DMSP source total"),
    "DMSP_R_B": DiagSpec(_L, _S_RATE, "DMSP removal by bacteria"),
    "DMSP_R_BKGND": DiagSpec(_L, _S_RATE, "DMSP background removal"),
    "DMSP_R_TOTAL": DiagSpec(_L, _S_RATE, "DMSP removal total"),
    "Cyano_frac": DiagSpec(_L, "1", "cyanobacteria fraction of smalls"),
    "Cocco_frac": DiagSpec(_L, "1", "coccolithophore fraction of smalls"),
    "Eukar_frac": DiagSpec(_L, "1", "eukaryote fraction of smalls"),
    "diatS": DiagSpec(_L, "mmol S/m^3", "diatom DMSP"),
    "diatN": DiagSpec(_L, "mmol N/m^3", "diatom nitrogen"),
    "phytoN": DiagSpec(_L, "mmol N/m^3", "total phytoplankton nitrogen"),
    "coccoS": DiagSpec(_L, "mmol S/m^3", "coccolithophore DMSP"),
    "cyanoS": DiagSpec(_L, "mmol S/m^3", "cyanobacteria DMSP"),
    "eukarS": DiagSpec(_L, "mmol S/m^3", "eukaryote DMSP"),
    "diazS": DiagSpec(_L, "mmol S/m^3", "diazotroph DMSP"),
    "phaeoS": DiagSpec(_L, "mmol S/m^3", "Phaeocystis DMSP"),
    "zooS": DiagSpec(_L, "mmol S/m^3", "zooplankton sulfur"),
    "zooCC": DiagSpec(_L, "mmol C/m^3", "zooplankton carbon (clipped)"),
    "RSNzoo": DiagSpec(_L, "1", "zooplankton S:N ratio"),
}

DMS_FLUX_DIAGS: Dict[str, DiagSpec] = {
    "DMS_IFRAC": DiagSpec(_C, "1", "ice fraction (clamped)"),
    "DMS_XKW": DiagSpec(_C, "cm/s", "ice-weighted transfer velocity"),
    "DMS_ATM_PRESS": DiagSpec(_C, "atm", "surface pressure"),
    "DMS_PV": DiagSpec(_C, "cm/s", "DMS piston velocity"),
    "DMS_SCHMIDT": DiagSpec(_C, "1", "DMS Schmidt number"),
    "DMS_SAT": DiagSpec(_C, _CONC, "DMS saturation concentration"),
    "DMS_SURF": DiagSpec(_C, _CONC, "surface DMS"),
    "DMS_WS": DiagSpec(_C, "m/s", "10 m wind speed"),
}

MACROS_DIAGS: Dict[str, DiagSpec] = {
    "PROT_S_TOTAL": DiagSpec(_L, _RATE, "protein source total"),
    "POLY_S_TOTAL": DiagSpec(_L, _RATE, "polysaccharide source total"),
    "LIP_S_TOTAL": DiagSpec(_L, _RATE, "lipid source total"),
    "PROT_R_TOTAL": DiagSpec(_L, _RATE, "protein removal total"),
    "POLY_R_TOTAL": DiagSpec(_L, _RATE, "polysaccharide removal total"),
    "LIP_R_TOTAL": DiagSpec(_L, _RATE, "lipid removal total"),
}


def coupled_registry() -> Dict[str, DiagSpec]:
    """Registry for the coupled-step diagnostics dict (DMS fields appear
    under their DMS_*-prefixed coupled names, MACROS under MACROS_*)."""
    reg: Dict[str, DiagSpec] = {}
    reg.update(BGC_DIAGS)
    reg.update(BGC_FLUX_DIAGS)
    for k, v in DMS_DIAGS.items():
        reg[k if k.startswith("DMS") else f"DMS_{k}"] = v
    reg.update(DMS_FLUX_DIAGS)
    for k, v in MACROS_DIAGS.items():
        reg[f"MACROS_{k}"] = v
    return reg
