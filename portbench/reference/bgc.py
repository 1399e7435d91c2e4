"""Scalar loop-based reference of the BGC ecosystem source-sink step.

One column / one level at a time, with explicit Python control flow and
carried sinking-particle state, following the physics of the Moore-2002
ecosystem independently of the port's vectorized code.  The pH solve
comes from ``carbonate.py``.
"""

from __future__ import annotations

import math

import numpy as np

from portbench.reference import carbonate as cref

# constants (duplicated deliberately: this file imports nothing of the
# program)
SPD = 86400.0
DPS = 1.0 / SPD
YPS = 1.0 / (365.0 * SPD)
Q = 0.137
QP_ZOO_POM = 0.00855
QFE_ZOO = 3.0e-6
GQSI_0, GQSI_MAX, GQSI_MIN = 0.137, 0.685, 0.0457
QCACO3_MAX = 0.4
EPSC, EPSTINV = 1.0e-8, 3.17e-8
CKS, CKSI = 9.0, 5.0
TREF, Q10 = 30.0, 1.5
THRES_Z1, THRES_Z2 = 100.0e2, 150.0e2
LOSS_THRES_ZOO = 0.005
CACO3_T1, CACO3_T2, CACO3_SP_THRES = 6.0, -2.0, 4.0
F_PHOTOSP_CACO3 = 0.4
CACO3_POC_MIN, SPC_POC_FAC, F_GRAZE_SP_POC_LIM = 0.4, 0.11, 0.3
F_GRAZE_CACO3_REMIN, F_GRAZE_SI_REMIN = 0.33, 0.35
R_NFIX_PHOTO = 1.25
RED_D_C_P = 117.0
RED_D_C_O2 = 117.0 / 170.0
REMIN_D_C_O2 = 117.0 / 138.0
RED_D_C_O2_DIAZ = 117.0 / 150.0
DENITRIF_C_N = 117.0 / 136.0
RED_FE_C = 3.0e-6
DOC_REMINR = (1.0 / 250.0) * DPS
DON_REMINR = (1.0 / 160.0) * DPS
DOFE_REMINR = (1.0 / 160.0) * DPS
DOP_REMINR = (1.0 / 160.0) * DPS
DONR_REMINR = (1.0 / (365.0 * 2.5)) * DPS
DOPR_REMINR = (1.0 / (365.0 * 2.5)) * DPS
DONREFRACT, DOPREFRACT = 0.08, 0.03
FE_SCAV_THRES1, DUST_FESCAV_SCALE, FE_MAX_SCALE2 = 0.8e-3, 1.0e9, 1200.0
DUST_TO_FE = 0.035 / 55.847 * 1.0e9
F_QSW_PAR = 0.45
DEL_PH, PHLO_3D, PHHI_3D = 0.2, 6.0, 9.0
TFNC_Q10, TFNC_MMRT = 1, 2

# tracer indices (canonical ordering of the package under test)
(PO4, NO3, SIO3, NH4, FE, O2T, DIC, DIC_ALT, ALK, DOC, DON, DOFE, DOP,
 DOPR, DONR, ZOOC) = range(16)
CHL_IND = (16, 20, 24, 27)
C_IND = (17, 21, 25, 28)
FE_IND = (18, 22, 26, 29)
SI_IND = (None, 23, None, None)
CA_IND = (19, None, None, None)


class Particle:
    def __init__(self):
        self.sflux_in = self.hflux_in = 0.0
        self.sflux_out = self.hflux_out = 0.0
        self.prod = self.remin = self.sed_loss = 0.0


def _par_cell(par_in, chl, dz):
    w = max(chl, 0.02)
    if w < 0.13224:
        kp = 0.000919 * w ** 0.3536
    else:
        kp = 0.001131 * w ** 0.4562
    kdz = kp * dz
    return par_in * math.exp(-kdz), par_in * (1 - math.exp(-kdz)) / kdz, kdz


def _scalelen(zbot, zs, vs):
    if zbot < zs[0]:
        return vs[0]
    if zbot >= zs[-1]:
        return vs[-1]
    for n in range(1, len(zs)):
        if zbot < zs[n]:
            return vs[n - 1] + (vs[n] - vs[n - 1]) * (zbot - zs[n - 1]) / (
                zs[n] - zs[n - 1])
    return vs[-1]


def bgc_source_sink_ref(tracers, grid, forcing, ph_prev, ph_prev_alt, p):
    """tracers (nlev, 30, ncol); grid/forcing dicts of numpy arrays;
    returns (tend, ph_new, ph_alt_new, diags dict)."""
    nlev, _, ncol = tracers.shape
    autos = p.autotrophs
    tend = np.zeros_like(tracers)
    ph_new = ph_prev.copy()
    ph_alt_new = ph_prev_alt.copy()
    diags = {
        "Jint_Ctot": np.zeros(ncol), "Jint_Ntot": np.zeros(ncol),
        "Jint_Ptot": np.zeros(ncol), "Jint_Sitot": np.zeros(ncol),
        "Jint_100m_Ctot": np.zeros(ncol), "Jint_100m_Ntot": np.zeros(ncol),
        "Jint_100m_Ptot": np.zeros(ncol), "Jint_100m_Sitot": np.zeros(ncol),
        "zsatcalc": np.zeros(ncol), "zsatarag": np.zeros(ncol),
        "O2_ZMIN": np.zeros(ncol), "O2_ZMIN_DEPTH": np.zeros(ncol),
        "CO3": np.zeros((nlev, ncol)), "pH_3D": np.zeros((nlev, ncol)),
        "POC_FLUX_IN": np.zeros((nlev, ncol)),
        "POC_REMIN": np.zeros((nlev, ncol)),
        # declared, zeroed, never assigned (BGC_parms.F90:206): stays zero
        "POC_ACCUM": np.zeros((nlev, ncol)),
        "NITRIF": np.zeros((nlev, ncol)),
        "DENITRIF": np.zeros((nlev, ncol)),
        "PAR_avg": np.zeros((nlev, ncol)),
        "tot_CaCO3_form": np.zeros((nlev, ncol)),
        "photoC_TOT_zint": np.zeros(ncol),
        "Chl_TOT_zint_100m": np.zeros(ncol),
        "pocToSed": np.zeros((nlev, ncol)),
        "SedDenitrif": np.zeros((nlev, ncol)),
        "OtherRemin": np.zeros((nlev, ncol)),
        "calcToSed": np.zeros((nlev, ncol)),
        "bsiToSed": np.zeros((nlev, ncol)),
        # test-only (underscore-prefixed, not reference diagnostics):
        # bottom-cell outgoing fluxes captured before bottom zeroing
        "_poc_flux_out_bot": np.zeros(ncol),
        "_sio2_flux_out_bot": np.zeros(ncol),
        "_caco3_flux_out_bot": np.zeros(ncol),
    }

    for col in range(ncol):
        kmax = int(grid["kmax"][col])
        if kmax < 1:
            continue
        lat = grid["latitude"][col]

        # particle init
        poc, caco3, sio2, dust, piron = (Particle() for _ in range(5))
        dust_in = max(0.0, forcing["dust_flux_in"][col])
        if dust_in != 0.0:
            dust.sflux_out = (1.0 - 0.97) * dust_in
            dust.hflux_out = 0.97 * dust_in
        rho_caco3 = 0.05 * 100.09 / 12.01
        rho_sio2 = 0.05 * 60.08 / 12.01
        rho_dust = 0.05 * 1.0e9 / 12.01
        qa_dust_def = rho_dust * (dust.sflux_out + dust.hflux_out)

        par_out = max(0.0, forcing["shortwave_surface"][col]) * F_QSW_PAR
        zsatcalc = zsatarag = 0.0
        anom_c_km1 = anom_a_km1 = 0.0

        for k in range(kmax):
            trc = np.maximum(tracers[k, :, col], 0.0)
            temp = forcing["potential_temperature"][k, col]
            salt = forcing["salinity"][k, col]
            dz = grid["cell_thickness"][k, col]
            center = grid["cell_center_depth"][k, col]
            zbot = grid["cell_bottom_depth"][k, col]

            # zero-mask
            achl, ac, afe, asi, aca = [], [], [], [], []
            for g, au in enumerate(autos):
                chl_g, c_g, fe_g = (trc[CHL_IND[g]], trc[C_IND[g]],
                                    trc[FE_IND[g]])
                si_g = trc[SI_IND[g]] if SI_IND[g] is not None else None
                ca_g = trc[CA_IND[g]] if CA_IND[g] is not None else None
                zm = chl_g == 0.0 or c_g == 0.0 or fe_g == 0.0
                if si_g is not None:
                    zm = zm or si_g == 0.0
                if zm:
                    chl_g = c_g = fe_g = 0.0
                    si_g = 0.0 if si_g is not None else None
                    ca_g = 0.0 if ca_g is not None else None
                achl.append(chl_g)
                ac.append(c_g)
                afe.append(fe_g)
                asi.append(si_g)
                aca.append(ca_g)

            thetaC = [achl[g] / (ac[g] + EPSC) for g in range(4)]
            qfe = [afe[g] / (ac[g] + EPSC) for g in range(4)]
            qsi = [min(asi[g] / (ac[g] + EPSC), GQSI_MAX)
                   if asi[g] is not None else None for g in range(4)]
            qca, gqfe, gqsi = [], [], []
            for g, au in enumerate(autos):
                gq = au.gQfe_0
                if trc[FE] < CKS * au.kFe:
                    gq = max(gq * trc[FE] / (CKS * au.kFe), au.gQfe_min)
                gqfe.append(gq)
                if au.has_si:
                    gs = GQSI_0
                    if (trc[FE] < CKSI * au.kFe and trc[FE] > 0.0
                            and trc[SIO3] > CKSI * au.kSiO3):
                        gs = min(gs * CKSI * au.kFe / trc[FE], GQSI_MAX)
                    if trc[FE] == 0.0:
                        gs = GQSI_MAX
                    if trc[SIO3] < CKSI * au.kSiO3:
                        gs = max(gs * trc[SIO3] / (CKSI * au.kSiO3),
                                 GQSI_MIN)
                    gqsi.append(gs)
                else:
                    gqsi.append(None)
                if au.imp_calcifier or au.exp_calcifier:
                    qca.append(min(aca[g] / (ac[g] + EPSC), QCACO3_MAX))
                else:
                    qca.append(None)

            par_in = par_out
            par_out, par_avg, kpar_dz = _par_cell(par_in, sum(achl), dz)
            diags["PAR_avg"][k, col] = par_avg

            # carbonate chemistry (diagnostics + warm-start only)
            depth_m = center * 0.01
            if ph_prev[k, col] != 0.0:
                lo, hi = ph_prev[k, col] - DEL_PH, ph_prev[k, col] + DEL_PH
            else:
                lo, hi = PHLO_3D, PHHI_3D
            ph3, h2co3, hco3, co3 = cref.co3_terms(
                depth_m, temp, salt, trc[DIC], trc[ALK], trc[PO4],
                trc[SIO3], lo, hi, k > 0)
            ph_new[k, col] = ph3
            if ph_prev_alt[k, col] != 0.0:
                lo, hi = (ph_prev_alt[k, col] - DEL_PH,
                          ph_prev_alt[k, col] + DEL_PH)
            else:
                lo, hi = PHLO_3D, PHHI_3D
            ph3a, _, _, _ = cref.co3_terms(
                depth_m, temp, salt, trc[DIC], trc[ALK], trc[PO4],
                trc[SIO3], lo, hi, k > 0)
            ph_alt_new[k, col] = ph3a
            satc, sata = cref.co3_sat(depth_m, temp, salt, k > 0)
            diags["CO3"][k, col] = co3
            diags["pH_3D"][k, col] = ph3

            if k == 0:
                zsatcalc = -1.0 if co3 > satc else 0.0
                zsatarag = -1.0 if co3 > sata else 0.0
            else:
                prev_center = grid["cell_center_depth"][k - 1, col]
                w4 = prev_center + (center - prev_center)
                if zsatcalc == -1.0 and co3 <= satc:
                    zsatcalc = w4 * anom_c_km1 / (anom_c_km1 - (co3 - satc))
                if zsatarag == -1.0 and co3 <= sata:
                    zsatarag = w4 * anom_a_km1 / (anom_a_km1 - (co3 - sata))
                if zsatcalc == -1.0 and k == kmax - 1:
                    zsatcalc = zbot
                if zsatarag == -1.0 and k == kmax - 1:
                    zsatarag = zbot
            anom_c_km1 = co3 - satc
            anom_a_km1 = co3 - sata

            tfunc = Q10 ** ((temp - TREF) / 10.0)
            if center > THRES_Z1:
                flt = ((THRES_Z2 - center) / (THRES_Z2 - THRES_Z1)
                       if center < THRES_Z2 else 0.0)
            else:
                flt = 1.0

            pprime = []
            for g, au in enumerate(autos):
                clt = flt * au.loss_thres
                if au.temp_function == TFNC_MMRT:
                    tmax = au.temp_thresN if lat >= 0.0 else au.temp_thresS
                    if temp > tmax:
                        clt = flt * au.loss_thres2
                else:
                    if temp < au.temp_thres:
                        clt = flt * au.loss_thres2
                pprime.append(max(ac[g] - clt, 0.0))

            vno3, vnh4, vntot = [], [], []
            no3_v, nh4_v, po4_v, dop_v = [], [], [], []
            photoC, photoFe, photoSi, photoacc = [], [], [], []
            caco3_prod_g = [None] * 4
            a_loss, a_agg, a_graze = [], [], []
            g_zoo, g_poc, g_doc, g_dic = [], [], [], []
            l_poc, l_doc, l_dic = [], [], []
            nfix = [None] * 4
            nexc = [None] * 4
            rp_dop = [None] * 4
            rp_dip = [None] * 4

            for g, au in enumerate(autos):
                v3 = (trc[NO3] / au.kNO3) / (1 + trc[NO3] / au.kNO3
                                             + trc[NH4] / au.kNH4)
                v4 = (trc[NH4] / au.kNH4) / (1 + trc[NO3] / au.kNO3
                                             + trc[NH4] / au.kNH4)
                vt = 1.0 if au.nfixer else v3 + v4
                vno3.append(v3)
                vnh4.append(v4)
                vntot.append(vt)
                vfe = trc[FE] / (trc[FE] + au.kFe)
                f_nut = min(vt, vfe)
                vp = (trc[PO4] / au.kPO4) / (1 + trc[PO4] / au.kPO4
                                             + trc[DOP] / au.kDOP)
                vd = (trc[DOP] / au.kDOP) / (1 + trc[PO4] / au.kPO4
                                             + trc[DOP] / au.kDOP)
                vpt = vp + vd
                f_nut = min(f_nut, vpt)
                if au.has_si:
                    vsi = trc[SIO3] / (trc[SIO3] + au.kSiO3)
                    f_nut = min(f_nut, vsi)

                pcmax = au.PCref * f_nut * tfunc
                if temp < au.temp_thres:
                    pcmax = 0.0
                if au.temp_function == TFNC_MMRT:
                    topt = au.temp_optN if lat >= 0.0 else au.temp_optS
                    tmax = au.temp_thresN if lat >= 0.0 else au.temp_thresS
                    pcmax *= min(1.0, (tmax - temp) / (tmax - topt))
                    if temp > tmax:
                        pcmax = 0.0
                llim = 1.0 - math.exp(
                    (-au.alphaPI * thetaC[g] * par_avg) / (pcmax + EPSTINV))
                pcph = pcmax * llim
                pc = pcph * ac[g]
                photoC.append(pc)

                if vt > 0.0:
                    no3_v.append((v3 / vt) * pc * Q)
                    nh4_v.append((v4 / vt) * pc * Q)
                    vnc = pcph * Q
                else:
                    no3_v.append(0.0)
                    nh4_v.append(0.0)
                    vnc = 0.0
                if vpt > 0.0:
                    po4_v.append((vp / vpt) * pc * au.Qp)
                    dop_v.append((vd / vpt) * pc * au.Qp)
                else:
                    po4_v.append(0.0)
                    dop_v.append(0.0)
                photoFe.append(pc * gqfe[g])
                photoSi.append(pc * gqsi[g] if au.has_si else None)
                w1 = au.alphaPI * thetaC[g] * par_avg
                if w1 > 0.0:
                    pchl = au.thetaN_max * pcph / w1
                    photoacc.append((pchl * vnc / thetaC[g]) * achl[g])
                else:
                    photoacc.append(0.0)

                if au.imp_calcifier:
                    cp = p.parm_f_prod_sp_CaCO3 * pc * f_nut
                    if temp < CACO3_T1:
                        cp *= max(temp - CACO3_T2, 0.0) / (CACO3_T1
                                                           - CACO3_T2)
                    if ac[g] > CACO3_SP_THRES:
                        cp = min(cp * ac[g] / CACO3_SP_THRES,
                                 F_PHOTOSP_CACO3 * pc)
                    caco3_prod_g[g] = cp
                    diags["tot_CaCO3_form"][k, col] += cp

                a_loss.append(au.mort * pprime[g] * tfunc)
                ag = min((au.agg_rate_max * DPS) * pprime[g],
                         au.mort2 * pprime[g] * pprime[g])
                ag = max((au.agg_rate_min * DPS) * pprime[g], ag)
                a_agg.append(ag)

            for g, au in enumerate(autos):
                gsum = sum(pprime[g2] for g2, au2 in enumerate(autos)
                           if au2.grazee_ind == au.grazee_ind)
                zum = au.z_umax_0 * tfunc
                if g == 1:
                    if lat >= 0.0 and temp > au.temp_optN:
                        zum *= max((au.temp_thresN - temp)
                                   / (au.temp_thresN - au.temp_optN), 0.95)
                    elif lat <= 0.0 and temp > au.temp_optS:
                        zum *= max((au.temp_thresS - temp)
                                   / (au.temp_thresS - au.temp_optS), 0.95)
                if gsum > 0.0:
                    gr = (pprime[g] / gsum) * zum * trc[ZOOC] * (
                        gsum / (gsum + au.z_grz))
                else:
                    gr = 0.0
                a_graze.append(gr)

                if au.nfixer:
                    wn = photoC[g] * Q
                    nfix[g] = wn * R_NFIX_PHOTO - no3_v[g] - nh4_v[g]
                    nexc[g] = nfix[g] + no3_v[g] + nh4_v[g] - wn

                gz = au.graze_zoo * gr
                if au.imp_calcifier:
                    gp = gr * max(CACO3_POC_MIN * qca[g],
                                  min(SPC_POC_FAC * max(1.0, pprime[g]),
                                      F_GRAZE_SP_POC_LIM))
                else:
                    gp = au.graze_poc * gr
                gd = au.graze_doc * gr
                g_zoo.append(gz)
                g_poc.append(gp)
                g_doc.append(gd)
                g_dic.append(gr - (gz + gp + gd))

                if au.imp_calcifier:
                    lp = qca[g] * a_loss[g]
                else:
                    lp = au.loss_poc * a_loss[g]
                l_poc.append(lp)
                l_doc.append((1 - p.parm_labile_ratio) * (a_loss[g] - lp))
                l_dic.append(p.parm_labile_ratio * (a_loss[g] - lp))

                if au.Qp != QP_ZOO_POM:
                    rp = ((gr + a_loss[g] + a_agg[g]) * au.Qp
                          - gz * QP_ZOO_POM
                          - (gp + lp + a_agg[g]) * QP_ZOO_POM)
                    rp_dop[g] = (1 - p.parm_labile_ratio) * rp
                    rp_dip[g] = p.parm_labile_ratio * rp

            w1 = sum(au.f_zoo_detr * (a_graze[g] + EPSC * EPSTINV)
                     for g, au in enumerate(autos))
            w2 = sum(a_graze[g] + EPSC * EPSTINV for g in range(4))
            f_zoo_detr = w1 / w2
            zprime = max(trc[ZOOC] - flt * LOSS_THRES_ZOO, 0.0)
            zoo_loss = (p.parm_z_mort2_0 * zprime ** 1.5
                        + p.parm_z_mort_0 * zprime) * tfunc
            zl_doc = (1 - p.parm_labile_ratio) * (1 - f_zoo_detr) * zoo_loss
            zl_dic = p.parm_labile_ratio * (1 - f_zoo_detr) * zoo_loss

            doc_prod = zl_doc + sum(l_doc) + sum(g_doc)
            don_prod = Q * doc_prod
            dop_prod = QP_ZOO_POM * zl_doc
            for g, au in enumerate(autos):
                if au.Qp == QP_ZOO_POM:
                    dop_prod += au.Qp * (l_doc[g] + g_doc[g])
                else:
                    dop_prod += rp_dop[g]
            dofe_prod = QFE_ZOO * zl_doc
            for g in range(4):
                dofe_prod += qfe[g] * (l_doc[g] + g_doc[g])

            doc_remin = trc[DOC] * DOC_REMINR
            don_remin = trc[DON] * DON_REMINR
            dofe_remin = trc[DOFE] * DOFE_REMINR
            dop_remin = trc[DOP] * DOP_REMINR
            if par_avg > 1.0:
                donr_remin = trc[DONR] * DONR_REMINR
                dopr_remin = trc[DOPR] * DOPR_REMINR
            else:
                donr_remin = trc[DONR] * (1 / (365.0 * 670.0)) * DPS
                dopr_remin = trc[DOPR] * (1 / (365.0 * 460.0)) * DPS
                doc_remin *= 0.0685
                don_remin *= 0.1
                dofe_remin *= 0.05
                dop_remin *= 0.05

            poc.prod = (f_zoo_detr * zoo_loss + sum(g_poc) + sum(a_agg)
                        + sum(l_poc))
            caco3.prod = 0.0
            sio2.prod = 0.0
            for g, au in enumerate(autos):
                if CA_IND[g] is not None:
                    caco3.prod = ((1 - F_GRAZE_CACO3_REMIN) * a_graze[g]
                                  + a_loss[g] + a_agg[g]) * qca[g]
                if au.has_si:
                    sio2.prod = qsi[g] * ((1 - F_GRAZE_SI_REMIN)
                                          * a_graze[g] + a_agg[g]
                                          + au.loss_poc * a_loss[g])

            fes_rate = p.parm_fe_scavenge_rate0 * (
                (poc.sflux_out + poc.hflux_out) * 120.1
                + (caco3.sflux_out + caco3.hflux_out) * 100.09
                + (sio2.sflux_out + sio2.hflux_out) * 60.08
                + (dust.sflux_out + dust.hflux_out) * DUST_FESCAV_SCALE)
            if trc[FE] > FE_SCAV_THRES1:
                fes_rate += (trc[FE] - FE_SCAV_THRES1) * FE_MAX_SCALE2
            fe_scav = YPS * trc[FE] * fes_rate
            piron.prod = zoo_loss * f_zoo_detr * QFE_ZOO + fe_scav
            for g in range(4):
                piron.prod += qfe[g] * (a_agg[g] + g_poc[g] + l_poc[g])

            # --- particulate terms ---
            for part in (caco3, sio2, dust, poc, piron):
                part.sflux_in = part.sflux_out
                part.hflux_in = part.hflux_out
                part.sed_loss = 0.0
            sed_denitrif = other_remin = 0.0

            sl = _scalelen(zbot, p.parm_scalelen_z, p.parm_scalelen_vals)
            decay_hard = math.exp(-dz / 4.0e6)
            decay_hard_dust = math.exp(-dz / 1.2e7)
            tfuncs = 1.5 ** ((temp - TREF) / 10.0)
            poc_diss = p.parm_POC_diss
            if 5.0 <= trc[O2T] < 40.0:
                poc_diss = p.parm_POC_diss * (1 + 2.3 * (40.0 - trc[O2T])
                                              / 35.0)
            elif trc[O2T] < 5.0:
                poc_diss = p.parm_POC_diss * 3.3
            poc_diss *= sl
            sio2_diss = sl * p.parm_SiO2_diss / tfuncs
            caco3_diss = sl * p.parm_CaCO3_diss
            dust_diss = sl * 20000.0
            d_poc = math.exp(-dz / poc_diss)
            d_sio2 = math.exp(-dz / sio2_diss)
            d_caco3 = math.exp(-dz / caco3_diss)
            d_dust = math.exp(-dz / dust_diss)

            caco3.sflux_out = (caco3.sflux_in * d_caco3
                               + caco3.prod * (0.70 * (1 - d_caco3)
                                               * caco3_diss))
            caco3.hflux_out = (caco3.hflux_in * decay_hard
                               + caco3.prod * 0.30 * dz)
            sio2.sflux_out = (sio2.sflux_in * d_sio2
                              + sio2.prod * (0.97 * (1 - d_sio2)
                                             * sio2_diss))
            sio2.hflux_out = (sio2.hflux_in * decay_hard
                              + sio2.prod * 0.030 * dz)
            dust.sflux_out = dust.sflux_in * d_dust
            dust.hflux_out = dust.hflux_in * decay_hard_dust

            avail = poc.prod - rho_caco3 * caco3.prod - rho_sio2 * sio2.prod
            if qa_dust_def > 0:
                new_qa = qa_dust_def * (dust.sflux_out + dust.hflux_out) / (
                    dust.sflux_in + dust.hflux_in)
            else:
                new_qa = 0.0
            if new_qa > 0.0:
                new_qa -= avail * dz
                if new_qa < 0.0:
                    avail = -new_qa / dz
                    new_qa = 0.0
                else:
                    avail = 0.0
            qa_dust_def = new_qa

            if poc.hflux_in == 0.0 and poc.prod == 0.0:
                poc.hflux_out = 0.0
            else:
                poc.hflux_out = max(
                    rho_caco3 * (caco3.sflux_out + caco3.hflux_out)
                    + rho_sio2 * (sio2.sflux_out + sio2.hflux_out)
                    + rho_dust * (dust.sflux_out + dust.hflux_out)
                    - new_qa, 0.0)
            poc.sflux_out = (poc.sflux_in * d_poc
                             + avail * (1 - d_poc) * poc_diss)

            caco3.remin = caco3.prod + ((caco3.sflux_in - caco3.sflux_out)
                                        + (caco3.hflux_in - caco3.hflux_out)
                                        ) / dz
            sio2.remin = sio2.prod + ((sio2.sflux_in - sio2.sflux_out)
                                      + (sio2.hflux_in - sio2.hflux_out)
                                      ) / dz
            poc.remin = poc.prod + ((poc.sflux_in - poc.sflux_out)
                                    + (poc.hflux_in - poc.hflux_out)) / dz
            dust.remin = ((dust.sflux_in - dust.sflux_out)
                          + (dust.hflux_in - dust.hflux_out)) / dz

            if poc.sflux_in + poc.hflux_in == 0.0:
                piron.remin = poc.remin * RED_FE_C
            else:
                piron.remin = poc.remin * (
                    piron.sflux_in + piron.hflux_in) / (
                    poc.sflux_in + poc.hflux_in)
            piron.remin += piron.sflux_in * 1.5e-5
            piron.sflux_out = piron.sflux_in + dz * (piron.prod
                                                     - piron.remin)
            if piron.sflux_out < 0.0:
                piron.sflux_out = 0.0
                piron.remin = piron.sflux_in / dz + piron.prod
            piron.remin += (dust.remin * DUST_TO_FE
                            + forcing["fesedflux"][k, col] / dz)
            piron.hflux_out = piron.hflux_in

            if k == kmax - 1:
                flux = poc.sflux_out + poc.hflux_out
                if flux > 0.0:
                    fa = flux * 0.01 * SPD
                    poc.sed_loss = flux * min(
                        0.8, p.parm_POMbury
                        * (0.013 + 0.53 * fa * fa / (7.0 + fa) ** 2))
                    sed_denitrif = (flux / dz) * (
                        0.06 + 0.19 * 0.99 ** (trc[O2T] - trc[NO3]))
                    if trc[NO3] < 5.0:
                        sed_denitrif = 0.0
                    fa2 = flux * 1e-6 * SPD * 365.0
                    other_remin = (1 / dz) * min(
                        min(0.1 + fa2, 0.5) * (flux - poc.sed_loss),
                        flux - poc.sed_loss
                        - sed_denitrif * dz * DENITRIF_C_N)
                    if trc[O2T] < 1.0:
                        other_remin = (1 / dz) * (
                            flux - poc.sed_loss
                            - sed_denitrif * dz * DENITRIF_C_N)
                flux = sio2.sflux_out + sio2.hflux_out
                eff = 0.2 if flux * 0.01 * SPD > 2.0 else 0.04
                sio2.sed_loss = flux * p.parm_BSIbury * eff
                if zbot < 3300.0e2:
                    caco3.sed_loss = caco3.sflux_out + caco3.hflux_out
                flux = caco3.sflux_out + caco3.hflux_out
                if flux > 0.0:
                    caco3.remin += (flux - caco3.sed_loss) / dz
                flux = sio2.sflux_out + sio2.hflux_out
                if flux > 0.0:
                    sio2.remin += (flux - sio2.sed_loss) / dz
                flux = poc.sflux_out + poc.hflux_out
                if flux > 0.0:
                    poc.remin += (flux - poc.sed_loss) / dz
                flux = piron.sflux_out + piron.hflux_out
                if flux > 0.0:
                    piron.sed_loss = flux
                dust.sed_loss = dust.sflux_out + dust.hflux_out
                # test-only captures of the bottom out-fluxes (before
                # the zeroing below), so directed bottom-branch tests
                # can verify the branch condition truly held
                diags["_poc_flux_out_bot"][col] = (poc.sflux_out
                                                   + poc.hflux_out)
                diags["_sio2_flux_out_bot"][col] = (sio2.sflux_out
                                                    + sio2.hflux_out)
                diags["_caco3_flux_out_bot"][col] = (caco3.sflux_out
                                                     + caco3.hflux_out)
                for part in (caco3, sio2, dust, poc, piron):
                    part.sflux_out = 0.0
                    part.hflux_out = 0.0

            diags["POC_FLUX_IN"][k, col] = poc.sflux_in + poc.hflux_in
            diags["POC_REMIN"][k, col] = poc.remin
            diags["pocToSed"][k, col] = poc.sed_loss
            diags["SedDenitrif"][k, col] = sed_denitrif * dz
            diags["OtherRemin"][k, col] = other_remin * dz
            diags["calcToSed"][k, col] = caco3.sed_loss
            diags["bsiToSed"][k, col] = sio2.sed_loss

            # --- nitrate & ammonium ---
            if p.lrest_no3:
                rest_no3 = forcing["nutr_restore_rtau"][k, col] * (
                    forcing["no3_clim"][k, col] - trc[NO3])
            else:
                rest_no3 = 0.0
            if par_out < p.parm_nitrif_par_lim:
                nitrif = p.parm_kappa_nitrif * trc[NH4]
                if par_in > p.parm_nitrif_par_lim:
                    nitrif *= math.log(
                        par_out / p.parm_nitrif_par_lim) / (-kpar_dz)
            else:
                nitrif = 0.0
            diags["NITRIF"][k, col] = nitrif

            wden = min(max(((p.parm_o2_min + p.parm_o2_min_delta)
                            - trc[O2T]) / p.parm_o2_min_delta, 0.0), 1.0)
            if trc[NO3] == 0.0:
                wden = 0.0
            denitrif = wden * ((doc_remin + poc.remin - other_remin)
                               / DENITRIF_C_N - sed_denitrif)
            diags["DENITRIF"][k, col] = denitrif

            td = tend[k, :, col]
            td[NO3] = (rest_no3 + nitrif - denitrif - sed_denitrif
                       - sum(no3_v))
            td[NH4] = (-sum(nh4_v) - nitrif + don_remin + donr_remin
                       + Q * (zl_dic + sum(l_dic) + sum(g_dic)
                              + poc.remin * (1 - DONREFRACT)))
            for g, au in enumerate(autos):
                if au.nfixer:
                    td[NH4] += nexc[g]

            td[FE] = (piron.remin + QFE_ZOO * zl_dic + dofe_remin
                      - sum(photoFe) - fe_scav)
            for g in range(4):
                td[FE] += (qfe[g] * (l_dic[g] + g_dic[g])
                           + g_zoo[g] * (qfe[g] - QFE_ZOO))

            if p.lrest_sio3:
                rest_si = forcing["nutr_restore_rtau"][k, col] * (
                    forcing["sio3_clim"][k, col] - trc[SIO3])
            else:
                rest_si = 0.0
            td[SIO3] = rest_si + sio2.remin
            for g, au in enumerate(autos):
                if au.has_si:
                    td[SIO3] += -photoSi[g] + qsi[g] * (
                        F_GRAZE_SI_REMIN * a_graze[g]
                        + (1 - au.loss_poc) * a_loss[g])

            if p.lrest_po4:
                rest_p = forcing["nutr_restore_rtau"][k, col] * (
                    forcing["po4_clim"][k, col] - trc[PO4])
            else:
                rest_p = 0.0
            td[PO4] = (rest_p + dop_remin + dopr_remin - sum(po4_v)
                       + QP_ZOO_POM * ((1 - DOPREFRACT) * poc.remin
                                       + zl_dic))
            for g, au in enumerate(autos):
                if au.Qp == QP_ZOO_POM:
                    td[PO4] += au.Qp * (l_dic[g] + g_dic[g])
                else:
                    td[PO4] += rp_dip[g]

            for g, au in enumerate(autos):
                wl = a_graze[g] + a_loss[g] + a_agg[g]
                td[C_IND[g]] = photoC[g] - wl
                td[CHL_IND[g]] = photoacc[g] - thetaC[g] * wl
                td[FE_IND[g]] = photoFe[g] - qfe[g] * wl
                if SI_IND[g] is not None:
                    td[SI_IND[g]] = photoSi[g] - qsi[g] * wl
                if CA_IND[g] is not None:
                    td[CA_IND[g]] = caco3_prod_g[g] - qca[g] * wl

            td[ZOOC] = sum(g_zoo) - zoo_loss
            td[DOC] = doc_prod - doc_remin
            td[DON] = don_prod * (1 - DONREFRACT) - don_remin
            td[DONR] = (don_prod * DONREFRACT - donr_remin
                        + poc.remin * DONREFRACT * Q)
            td[DOP] = (dop_prod * (1 - DOPREFRACT) - dop_remin
                       - sum(dop_v))
            td[DOPR] = (dop_prod * DOPREFRACT - dopr_remin
                        + poc.remin * DOPREFRACT * QP_ZOO_POM)
            td[DOFE] = dofe_prod - dofe_remin

            td[DIC] = (sum(l_dic) + sum(g_dic) - sum(photoC) + doc_remin
                       + poc.remin + zl_dic + caco3.remin)
            for g, au in enumerate(autos):
                if CA_IND[g] is not None:
                    td[DIC] += (F_GRAZE_CACO3_REMIN * a_graze[g] * qca[g]
                                - caco3_prod_g[g])
            td[DIC_ALT] = td[DIC] if p.alt_co2_use_eco else 0.0

            td[ALK] = -td[NO3] + td[NH4] + 2 * caco3.remin
            for g, au in enumerate(autos):
                if CA_IND[g] is not None:
                    td[ALK] += 2 * (F_GRAZE_CACO3_REMIN * a_graze[g]
                                    * qca[g] - caco3_prod_g[g])

            o2p = 0.0
            for g, au in enumerate(autos):
                if photoC[g] > 0.0:
                    if not au.nfixer:
                        den = no3_v[g] + nh4_v[g]
                        o2p += photoC[g] * (
                            (no3_v[g] / den) / RED_D_C_O2
                            + (nh4_v[g] / den) / REMIN_D_C_O2)
                    else:
                        den = no3_v[g] + nh4_v[g] + nfix[g]
                        o2p += photoC[g] * (
                            (no3_v[g] / den) / RED_D_C_O2
                            + (nh4_v[g] / den) / REMIN_D_C_O2
                            + (nfix[g] / den) / RED_D_C_O2_DIAZ)
            wo2 = min(max((trc[O2T] - p.parm_o2_min)
                          / p.parm_o2_min_delta, 0.0), 1.0)
            o2c = wo2 * ((poc.remin + doc_remin
                          - sed_denitrif * DENITRIF_C_N - other_remin
                          + zl_dic + sum(l_dic) + sum(g_dic))
                         / REMIN_D_C_O2 + 2 * nitrif)
            td[O2T] = o2p - o2c

            # conservation integrals
            ztop = grid["cell_bottom_depth"][k - 1, col] if k > 0 else 0.0
            w2_ = min(100.0e2 - ztop, dz)
            pth = w2_ if w2_ > 0.0 else 0.0

            ctot = (td[DIC] + td[DOC] + td[ZOOC]
                    + sum(td[C_IND[g]] for g in range(4))
                    + sum(td[CA_IND[g]] for g in range(4)
                          if CA_IND[g] is not None))
            diags["Jint_Ctot"][col] += (ctot * dz + poc.sed_loss
                                        + caco3.sed_loss)
            in100 = zbot <= 100.0e2
            diags["Jint_100m_Ctot"][col] += ctot * pth + (
                (poc.sed_loss + caco3.sed_loss) if in100 else 0.0)

            ntot = (td[NO3] + td[NH4] + td[DON] + td[DONR]
                    + Q * td[ZOOC] + Q * sum(td[C_IND[g]]
                                             for g in range(4)))
            ntot += denitrif + sed_denitrif
            for g, au in enumerate(autos):
                if au.nfixer:
                    ntot -= nfix[g]
            diags["Jint_Ntot"][col] += ntot * dz + poc.sed_loss * Q
            diags["Jint_100m_Ntot"][col] += ntot * pth + (
                poc.sed_loss * Q if in100 else 0.0)

            ptot = (td[PO4] + td[DOP] + td[DOPR] + QP_ZOO_POM * td[ZOOC]
                    + sum(au.Qp * td[C_IND[g]]
                          for g, au in enumerate(autos)))
            diags["Jint_Ptot"][col] += ptot * dz + poc.sed_loss * QP_ZOO_POM
            diags["Jint_100m_Ptot"][col] += ptot * pth + (
                poc.sed_loss * QP_ZOO_POM if in100 else 0.0)

            sitot = td[SIO3] + sum(td[SI_IND[g]] for g in range(4)
                                   if SI_IND[g] is not None)
            diags["Jint_Sitot"][col] += sitot * dz + sio2.sed_loss
            diags["Jint_100m_Sitot"][col] += sitot * pth + (
                sio2.sed_loss if in100 else 0.0)

            diags["photoC_TOT_zint"][col] += sum(photoC) * dz
            diags["Chl_TOT_zint_100m"][col] += sum(achl) * pth

        diags["zsatcalc"][col] = zsatcalc
        diags["zsatarag"][col] = zsatarag

        # O2 minimum
        o2col = np.maximum(tracers[:kmax, O2T, col], 0.0)
        w2 = o2col[0]
        w3 = grid["cell_center_depth"][0, col]
        for k in range(1, kmax):
            if o2col[k] < w2:
                w2 = o2col[k]
                w3 = grid["cell_center_depth"][k, col]
        diags["O2_ZMIN"][col] = w2
        diags["O2_ZMIN_DEPTH"][col] = w3

    return tend, ph_new, ph_alt_new, diags
