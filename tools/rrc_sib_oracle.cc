// Golden-vector generator for the SIB4-9/13 RRC codecs.
//
// Compiles against the *reference* codec (lib/src/asn1/liblte_rrc.cc — used
// as an executable oracle only, no code copied) and prints the UPER bit
// string the reference produces for a fixed set of SIB values. The printed
// vectors are frozen into tests/test_rrc.py and checked against
// empower_srslte_tpu/rrc/messages.py.
//
// Build/run:
//   g++ -O1 -I /root/reference/lib/include tools/rrc_sib_oracle.cc \
//       /root/reference/lib/src/asn1/liblte_rrc.cc \
//       /root/reference/lib/src/asn1/liblte_common.cc -o /tmp/rrc_sib_oracle
//   /tmp/rrc_sib_oracle

#include "srslte/asn1/liblte_rrc.h"
#include <cstdio>
#include <cstring>

static LIBLTE_BIT_MSG_STRUCT bits;

static void show(const char* name, uint8* start, uint8* end) {
  printf("%s ", name);
  for (uint8* p = start; p < end; p++) putchar(*p ? '1' : '0');
  printf("\n");
}

int main() {
  uint8* p;

  // ---- SIB4: 2 neighbours, 1 black cell, no CSG ----------------------------
  LIBLTE_RRC_SYS_INFO_BLOCK_TYPE_4_STRUCT sib4;
  memset(&sib4, 0, sizeof(sib4));
  sib4.intra_freq_neigh_cell_list_size = 2;
  sib4.intra_freq_neigh_cell_list[0].phys_cell_id = 101;
  sib4.intra_freq_neigh_cell_list[0].q_offset_range = LIBLTE_RRC_Q_OFFSET_RANGE_DB_0;
  sib4.intra_freq_neigh_cell_list[1].phys_cell_id = 405;
  sib4.intra_freq_neigh_cell_list[1].q_offset_range = LIBLTE_RRC_Q_OFFSET_RANGE_DB_N6;
  sib4.intra_freq_black_cell_list_size = 1;
  sib4.intra_freq_black_cell_list[0].start = 77;
  sib4.intra_freq_black_cell_list[0].range = LIBLTE_RRC_PHYS_CELL_ID_RANGE_N8;
  sib4.csg_phys_cell_id_range_present = false;
  p = bits.msg;
  liblte_rrc_pack_sys_info_block_type_4_ie(&sib4, &p);
  show("SIB4A", bits.msg, p);

  // ---- SIB4: CSG range only ------------------------------------------------
  memset(&sib4, 0, sizeof(sib4));
  sib4.csg_phys_cell_id_range_present = true;
  sib4.csg_phys_cell_id_range.start = 330;
  sib4.csg_phys_cell_id_range.range = LIBLTE_RRC_PHYS_CELL_ID_RANGE_N1; // absent
  p = bits.msg;
  liblte_rrc_pack_sys_info_block_type_4_ie(&sib4, &p);
  show("SIB4B", bits.msg, p);

  // ---- SIB5: one full carrier + one minimal --------------------------------
  LIBLTE_RRC_SYS_INFO_BLOCK_TYPE_5_STRUCT sib5;
  memset(&sib5, 0, sizeof(sib5));
  sib5.inter_freq_carrier_freq_list_size = 2;
  LIBLTE_RRC_INTER_FREQ_CARRIER_FREQ_INFO_STRUCT* c = &sib5.inter_freq_carrier_freq_list[0];
  c->dl_carrier_freq = 3100;
  c->q_rx_lev_min = -60;         // actual dBm value (packed as (v/2)-lo? check)
  c->p_max_present = true; c->p_max = 10;
  c->t_resel_eutra = 3;
  c->t_resel_eutra_sf_present = true;
  c->t_resel_eutra_sf.sf_medium = LIBLTE_RRC_SSSF_MEDIUM_0DOT5;
  c->t_resel_eutra_sf.sf_high = LIBLTE_RRC_SSSF_HIGH_0DOT75;
  c->threshx_high = 12; c->threshx_low = 5;
  c->allowed_meas_bw = LIBLTE_RRC_ALLOWED_MEAS_BANDWIDTH_MBW50;
  c->presence_ant_port_1 = true;
  c->cell_resel_prio_present = true; c->cell_resel_prio = 6;
  c->neigh_cell_cnfg = 2;
  c->q_offset_freq = LIBLTE_RRC_Q_OFFSET_RANGE_DB_2;
  c->inter_freq_neigh_cell_list_size = 1;
  c->inter_freq_neigh_cell_list[0].phys_cell_id = 88;
  c->inter_freq_neigh_cell_list[0].q_offset_cell = LIBLTE_RRC_Q_OFFSET_RANGE_DB_N2;
  c->inter_freq_black_cell_list_size = 1;
  c->inter_freq_black_cell_list[0].start = 400;
  c->inter_freq_black_cell_list[0].range = LIBLTE_RRC_PHYS_CELL_ID_RANGE_N504;
  c = &sib5.inter_freq_carrier_freq_list[1];
  c->dl_carrier_freq = 6400;
  c->q_rx_lev_min = -70;
  c->p_max_present = false;
  c->t_resel_eutra = 1;
  c->t_resel_eutra_sf_present = false;
  c->threshx_high = 31; c->threshx_low = 0;
  c->allowed_meas_bw = LIBLTE_RRC_ALLOWED_MEAS_BANDWIDTH_MBW6;
  c->presence_ant_port_1 = false;
  c->cell_resel_prio_present = false;
  c->neigh_cell_cnfg = 1;
  c->q_offset_freq = LIBLTE_RRC_Q_OFFSET_RANGE_DB_0; // default -> absent
  c->inter_freq_neigh_cell_list_size = 0;
  c->inter_freq_black_cell_list_size = 0;
  p = bits.msg;
  liblte_rrc_pack_sys_info_block_type_5_ie(&sib5, &p);
  show("SIB5", bits.msg, p);

  // ---- SIB6: 1 FDD + 1 TDD ------------------------------------------------
  LIBLTE_RRC_SYS_INFO_BLOCK_TYPE_6_STRUCT sib6;
  memset(&sib6, 0, sizeof(sib6));
  sib6.carrier_freq_list_utra_fdd_size = 1;
  sib6.carrier_freq_list_utra_fdd[0].carrier_freq = 10563;
  sib6.carrier_freq_list_utra_fdd[0].cell_resel_prio_present = true;
  sib6.carrier_freq_list_utra_fdd[0].cell_resel_prio = 4;
  sib6.carrier_freq_list_utra_fdd[0].threshx_high = 7;
  sib6.carrier_freq_list_utra_fdd[0].threshx_low = 3;
  sib6.carrier_freq_list_utra_fdd[0].q_rx_lev_min = -55;
  sib6.carrier_freq_list_utra_fdd[0].p_max_utra = 0;
  sib6.carrier_freq_list_utra_fdd[0].q_qual_min = -12;
  sib6.carrier_freq_list_utra_tdd_size = 1;
  sib6.carrier_freq_list_utra_tdd[0].carrier_freq = 9400;
  sib6.carrier_freq_list_utra_tdd[0].cell_resel_prio_present = false;
  sib6.carrier_freq_list_utra_tdd[0].threshx_high = 6;
  sib6.carrier_freq_list_utra_tdd[0].threshx_low = 2;
  sib6.carrier_freq_list_utra_tdd[0].q_rx_lev_min = -50;
  sib6.carrier_freq_list_utra_tdd[0].p_max_utra = -20;
  sib6.t_resel_utra = 2;
  sib6.t_resel_utra_sf_present = true;
  sib6.t_resel_utra_sf.sf_medium = LIBLTE_RRC_SSSF_MEDIUM_1DOT0;
  sib6.t_resel_utra_sf.sf_high = LIBLTE_RRC_SSSF_HIGH_0DOT25;
  p = bits.msg;
  liblte_rrc_pack_sys_info_block_type_6_ie(&sib6, &p);
  show("SIB6", bits.msg, p);

  // ---- SIB7: explicit-list + equally-spaced GERAN groups -------------------
  LIBLTE_RRC_SYS_INFO_BLOCK_TYPE_7_STRUCT sib7;
  memset(&sib7, 0, sizeof(sib7));
  sib7.t_resel_geran = 1;
  sib7.t_resel_geran_sf_present = false;
  sib7.carrier_freqs_info_list_size = 2;
  LIBLTE_RRC_CARRIER_FREQS_INFO_LIST_GERAN_STRUCT* g = &sib7.carrier_freqs_info_list[0];
  g->carrier_freqs.starting_arfcn = 512;
  g->carrier_freqs.band_indicator = LIBLTE_RRC_BAND_INDICATOR_GERAN_DCS1800;
  g->carrier_freqs.following_arfcns = LIBLTE_RRC_FOLLOWING_ARFCNS_EXPLICIT_LIST;
  g->carrier_freqs.explicit_list_of_arfcns_size = 2;
  g->carrier_freqs.explicit_list_of_arfcns[0] = 514;
  g->carrier_freqs.explicit_list_of_arfcns[1] = 516;
  g->cell_resel_prio_present = true; g->cell_resel_prio = 1;
  g->ncc_permitted = 0xFF;
  g->q_rx_lev_min = -95; // IE 10
  g->p_max_geran_present = true; g->p_max_geran = 30;
  g->threshx_high = 9; g->threshx_low = 4;
  g = &sib7.carrier_freqs_info_list[1];
  g->carrier_freqs.starting_arfcn = 64;
  g->carrier_freqs.band_indicator = LIBLTE_RRC_BAND_INDICATOR_GERAN_PCS1900;
  g->carrier_freqs.following_arfcns = LIBLTE_RRC_FOLLOWING_ARFCNS_EQUALLY_SPACED;
  g->carrier_freqs.equally_spaced_arfcns.arfcn_spacing = 2;
  g->carrier_freqs.equally_spaced_arfcns.number_of_arfcns = 10;
  g->cell_resel_prio_present = false;
  g->ncc_permitted = 0x81;
  g->q_rx_lev_min = -73; // IE 21
  g->p_max_geran_present = false;
  g->threshx_high = 11; g->threshx_low = 8;
  p = bits.msg;
  liblte_rrc_pack_sys_info_block_type_7_ie(&sib7, &p);
  show("SIB7", bits.msg, p);

  // ---- SIB8: everything present (sync system time) -------------------------
  LIBLTE_RRC_SYS_INFO_BLOCK_TYPE_8_STRUCT sib8;
  memset(&sib8, 0, sizeof(sib8));
  sib8.sys_time_info_present = true;
  sib8.sys_time_info_cdma2000.cdma_eutra_sync = true;
  sib8.sys_time_info_cdma2000.system_time_async = false;
  sib8.sys_time_info_cdma2000.system_time = 0x123456789aULL;
  sib8.search_win_size_present = true;
  sib8.search_win_size = 9;
  sib8.params_hrpd_present = true;
  sib8.pre_reg_info_hrpd.pre_reg_allowed = true;
  sib8.pre_reg_info_hrpd.pre_reg_zone_id_present = true;
  sib8.pre_reg_info_hrpd.pre_reg_zone_id = 42;
  sib8.pre_reg_info_hrpd.secondary_pre_reg_zone_id_list_size = 2;
  sib8.pre_reg_info_hrpd.secondary_pre_reg_zone_id_list[0] = 7;
  sib8.pre_reg_info_hrpd.secondary_pre_reg_zone_id_list[1] = 9;
  sib8.cell_resel_params_hrpd_present = true;
  sib8.cell_resel_params_hrpd.band_class_list_size = 1;
  sib8.cell_resel_params_hrpd.band_class_list[0].band_class = LIBLTE_RRC_BAND_CLASS_CDMA2000_BC1;
  sib8.cell_resel_params_hrpd.band_class_list[0].cell_resel_prio_present = true;
  sib8.cell_resel_params_hrpd.band_class_list[0].cell_resel_prio = 5;
  sib8.cell_resel_params_hrpd.band_class_list[0].thresh_x_high = 40;
  sib8.cell_resel_params_hrpd.band_class_list[0].thresh_x_low = 20;
  sib8.cell_resel_params_hrpd.neigh_cell_list_size = 1;
  sib8.cell_resel_params_hrpd.neigh_cell_list[0].band_class = LIBLTE_RRC_BAND_CLASS_CDMA2000_BC0;
  sib8.cell_resel_params_hrpd.neigh_cell_list[0].neigh_cells_per_freq_list_size = 1;
  sib8.cell_resel_params_hrpd.neigh_cell_list[0].neigh_cells_per_freq_list[0].arfcn = 283;
  sib8.cell_resel_params_hrpd.neigh_cell_list[0].neigh_cells_per_freq_list[0].phys_cell_id_list_size = 2;
  sib8.cell_resel_params_hrpd.neigh_cell_list[0].neigh_cells_per_freq_list[0].phys_cell_id_list[0] = 100;
  sib8.cell_resel_params_hrpd.neigh_cell_list[0].neigh_cells_per_freq_list[0].phys_cell_id_list[1] = 200;
  sib8.cell_resel_params_hrpd.t_resel_cdma2000 = 4;
  sib8.cell_resel_params_hrpd.t_resel_cdma2000_sf_present = false;
  sib8.params_1xrtt_present = true;
  sib8.csfb_reg_param_1xrtt_present = true;
  sib8.csfb_reg_param_1xrtt.sid = 0x1234;
  sib8.csfb_reg_param_1xrtt.nid = 0xABCD;
  sib8.csfb_reg_param_1xrtt.multiple_sid = true;
  sib8.csfb_reg_param_1xrtt.multiple_nid = false;
  sib8.csfb_reg_param_1xrtt.home_reg = true;
  sib8.csfb_reg_param_1xrtt.foreign_sid_reg = false;
  sib8.csfb_reg_param_1xrtt.foreign_nid_reg = true;
  sib8.csfb_reg_param_1xrtt.param_reg = false;
  sib8.csfb_reg_param_1xrtt.power_up_reg = true;
  sib8.csfb_reg_param_1xrtt.reg_period = 0x55;
  sib8.csfb_reg_param_1xrtt.reg_zone = 0x9A2;
  sib8.csfb_reg_param_1xrtt.total_zone = 5;
  sib8.csfb_reg_param_1xrtt.zone_timer = 2;
  sib8.long_code_state_1xrtt_present = true;
  sib8.long_code_state_1xrtt = 0x2BBBBCCCCDULL;
  sib8.cell_resel_params_1xrtt_present = false;
  p = bits.msg;
  liblte_rrc_pack_sys_info_block_type_8_ie(&sib8, &p);
  show("SIB8", bits.msg, p);

  // ---- SIB9 ----------------------------------------------------------------
  LIBLTE_RRC_SYS_INFO_BLOCK_TYPE_9_STRUCT sib9;
  memset(&sib9, 0, sizeof(sib9));
  sib9.hnb_name_present = true;
  sib9.hnb_name_size = 5;
  memcpy(sib9.hnb_name, "srs-1", 5);
  p = bits.msg;
  liblte_rrc_pack_sys_info_block_type_9_ie(&sib9, &p);
  show("SIB9", bits.msg, p);

  // ---- SIB13 ---------------------------------------------------------------
  LIBLTE_RRC_SYS_INFO_BLOCK_TYPE_13_STRUCT sib13;
  memset(&sib13, 0, sizeof(sib13));
  sib13.mbsfn_area_info_list_r9_size = 1;
  sib13.mbsfn_area_info_list_r9[0].mbsfn_area_id_r9 = 3;
  sib13.mbsfn_area_info_list_r9[0].non_mbsfn_region_length = LIBLTE_RRC_NON_MBSFN_REGION_LENGTH_S2;
  sib13.mbsfn_area_info_list_r9[0].notification_indicator_r9 = 0;
  sib13.mbsfn_area_info_list_r9[0].mcch_repetition_period_r9 = LIBLTE_RRC_MCCH_REPETITION_PERIOD_RF64;
  sib13.mbsfn_area_info_list_r9[0].mcch_offset_r9 = 5;
  sib13.mbsfn_area_info_list_r9[0].mcch_modification_period_r9 = LIBLTE_RRC_MCCH_MODIFICATION_PERIOD_512;
  sib13.mbsfn_area_info_list_r9[0].sf_alloc_info_r9 = 0x20;
  sib13.mbsfn_area_info_list_r9[0].signalling_mcs_r9 = LIBLTE_RRC_MCCH_SIGNALLING_MCS_N7;
  sib13.mbsfn_notification_config.repetition_coeff = LIBLTE_RRC_NOTIFICATION_REPETITION_COEFF_R9_N2;
  sib13.mbsfn_notification_config.offset = 0;
  sib13.mbsfn_notification_config.sf_index = 1;
  p = bits.msg;
  liblte_rrc_pack_sys_info_block_type_13_ie(&sib13, &p);
  show("SIB13", bits.msg, p);

  // ---- Full SystemInformation container: [SIB4A, SIB13] --------------------
  LIBLTE_RRC_SYS_INFO_MSG_STRUCT si;
  memset(&si, 0, sizeof(si));
  si.N_sibs = 2;
  si.sibs[0].sib_type = LIBLTE_RRC_SYS_INFO_BLOCK_TYPE_4;
  memset(&si.sibs[0].sib.sib4, 0, sizeof(si.sibs[0].sib.sib4));
  si.sibs[0].sib.sib4.intra_freq_neigh_cell_list_size = 2;
  si.sibs[0].sib.sib4.intra_freq_neigh_cell_list[0].phys_cell_id = 101;
  si.sibs[0].sib.sib4.intra_freq_neigh_cell_list[0].q_offset_range = LIBLTE_RRC_Q_OFFSET_RANGE_DB_0;
  si.sibs[0].sib.sib4.intra_freq_neigh_cell_list[1].phys_cell_id = 405;
  si.sibs[0].sib.sib4.intra_freq_neigh_cell_list[1].q_offset_range = LIBLTE_RRC_Q_OFFSET_RANGE_DB_N6;
  si.sibs[0].sib.sib4.intra_freq_black_cell_list_size = 1;
  si.sibs[0].sib.sib4.intra_freq_black_cell_list[0].start = 77;
  si.sibs[0].sib.sib4.intra_freq_black_cell_list[0].range = LIBLTE_RRC_PHYS_CELL_ID_RANGE_N8;
  si.sibs[1].sib_type = LIBLTE_RRC_SYS_INFO_BLOCK_TYPE_13;
  si.sibs[1].sib.sib13 = sib13;
  LIBLTE_BIT_MSG_STRUCT msg;
  liblte_rrc_pack_sys_info_msg(&si, &msg);
  show("SI_MSG", msg.msg, msg.msg + msg.N_bits);

  return 0;
}
