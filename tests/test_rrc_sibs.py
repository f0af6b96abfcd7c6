"""SIB4-13 codec parity against the reference encoder.

Golden bit strings generated by tools/rrc_sib_oracle.cc, which drives the
reference's own codec (lib/src/asn1/liblte_rrc.cc pack_sys_info_block_
type_{4..9,13}_ie) over fixed values — the reference is executed as an
oracle, never copied. Values below are the same ones the oracle packs.

Container note: the reference's liblte_rrc_pack_sys_info_msg has a
padding bug for extension SIBs (it pads ``content % 8`` bits instead of
``-content % 8``, so its SIB13 open type is shorter than its own length
determinant claims — verified on the oracle output, 42 bits carried vs
48 declared). Our container follows X.691 10.2 exactly, so the container
test checks the root-SIB prefix bit-exactly and our own round-trip for
the extension part.
"""

from empower_srslte_tpu.rrc import messages as M
from empower_srslte_tpu.rrc.per import BitReader, BitWriter

# Q-OffsetRange enum indices (dB-24..dB24): dB0=15, dB-6=9, dB2=17, dB-2=13


def bits_of(typ, value) -> str:
    w = BitWriter()
    typ.pack(w, value)
    return "".join(str(b) for b in w.bits)


def roundtrip(typ, value):
    w = BitWriter()
    typ.pack(w, value)
    return typ.unpack(BitReader(w.to_bytes(), len(w)))


SIB4A_VAL = {
    "intra_freq_neigh_cell_list": [
        {"phys_cell_id": 101, "q_offset_cell": 15},
        {"phys_cell_id": 405, "q_offset_cell": 9},
    ],
    "intra_freq_black_cell_list": [{"start": 77, "range": 1}],  # n8
}
SIB4A_BITS = "01100001000110010101111011001010101001000010010011010001"

SIB4B_VAL = {"csg_phys_cell_id_range": {"start": 330}}
SIB4B_BITS = "00010101001010"

SIB5_VAL = {
    "inter_freq_carrier_freq_list": [
        {
            "dl_carrier_freq": 3100,
            "q_rx_lev_min": -30,
            "p_max": 10,
            "t_reselection_eutra": 3,
            "t_reselection_eutra_sf": {"sf_medium": 1, "sf_high": 2},
            "thresh_x_high": 6,
            "thresh_x_low": 2,
            "allowed_meas_bandwidth": 3,  # mbw50
            "presence_antenna_port1": True,
            "cell_reselection_priority": 6,
            "neigh_cell_config": 2,
            "q_offset_freq": 17,  # dB2
            "inter_freq_neigh_cell_list": [
                {"phys_cell_id": 88, "q_offset_cell": 13}],
            "inter_freq_black_cell_list": [{"start": 400, "range": 13}],
        },
        {
            "dl_carrier_freq": 6400,
            "q_rx_lev_min": -35,
            "t_reselection_eutra": 1,
            "thresh_x_high": 15,
            "thresh_x_low": 0,
            "allowed_meas_bandwidth": 0,  # mbw6
            "presence_antenna_port1": False,
            "neigh_cell_config": 1,
        },
    ],
}
SIB5_BITS = ("000101111100001100000111001010001010000110110001100001001111101010"
             "001000000101100001101000011100100001101000000000110010000000010001"
             "1001011110000000000101111")

SIB6_VAL = {
    "carrier_freq_list_utra_fdd": [{
        "carrier_freq": 10563,
        "cell_reselection_priority": 4,
        "thresh_x_high": 3,
        "thresh_x_low": 1,
        "q_rx_lev_min": -28,
        "p_max_utra": 0,
        "q_qual_min": -12,
    }],
    "carrier_freq_list_utra_tdd": [{
        "carrier_freq": 9400,
        "thresh_x_high": 3,
        "thresh_x_low": 1,
        "q_rx_lev_min": -25,
        "p_max_utra": -20,
    }],
    "t_reselection_utra": 2,
    "t_reselection_utra_sf": {"sf_medium": 3, "sf_high": 0},
}
SIB6_BITS = ("011100000110100101000011100000110000110000001100100110000000010010"
             "010111000000110000110001100111100101100")

SIB7_VAL = {
    "t_reselection_geran": 1,
    "carrier_freqs_info_list": [
        {
            "carrier_freqs": {
                "starting_arfcn": 512,
                "band_indicator": "dcs1800",
                "following_arfcns": ("explicitListOfARFCNs", [514, 516]),
            },
            "common_info": {
                "cell_reselection_priority": 1,
                "ncc_permitted": 0xFF,
                "q_rx_lev_min": 10,
                "p_max_geran": 30,
                "thresh_x_high": 4,
                "thresh_x_low": 2,
            },
        },
        {
            "carrier_freqs": {
                "starting_arfcn": 64,
                "band_indicator": "pcs1900",
                "following_arfcns": ("equallySpacedARFCNs", {
                    "arfcn_spacing": 2,
                    "number_of_following_arfcns": 10}),
            },
            "common_info": {
                "ncc_permitted": 0x81,
                "q_rx_lev_min": 21,
                "thresh_x_high": 5,
                "thresh_x_low": 4,
            },
        },
    ],
}
SIB7_BITS = ("001001000101000000000000000101000000010100000010011001111111110010"
             "100111100010000010000010000001010010101000100000010101010010100100")

SIB8_VAL = {
    "system_time_info": {
        "cdma_eutra_synchronisation": True,
        "cdma_system_time": ("synchronousSystemTime", 0x123456789A),
    },
    "search_window_size": 9,
    "parameters_hrpd": {
        "pre_registration_info_hrpd": {
            "pre_registration_allowed": True,
            "pre_registration_zone_id": 42,
            "secondary_pre_registration_zone_id_list": [7, 9],
        },
        "cell_reselection_parameters_hrpd": {
            "band_class_list": [{
                "band_class": 1,  # bc1
                "cell_reselection_priority": 5,
                "thresh_x_high": 40,
                "thresh_x_low": 20,
            }],
            "neigh_cell_list": [{
                "band_class": 0,  # bc0
                "neigh_cells_per_freq_list": [{
                    "arfcn": 283,
                    "phys_cell_id_list": [100, 200]}],
            }],
            "t_reselection_cdma2000": 4,
        },
    },
    "parameters_1xrtt": {
        "csfb_registration_param_1xrtt": {
            "sid": 0x1234, "nid": 0xABCD,
            "multiple_sid": True, "multiple_nid": False,
            "home_reg": True, "foreign_sid_reg": False,
            "foreign_nid_reg": True, "parameter_reg": False,
            "power_up_reg": True, "registration_period": 0x55,
            "registration_zone": 0x9A2, "total_zone": 5, "zone_timer": 2,
        },
        "long_code_state_1xrtt": 0x2BBBBCCCCD,
    },
}
SIB8_BITS = ("011111000100100011010001010110011110001001101010011111001010101000"
             "001110000100100000001000001101101000010100000000000000000010001101"
             "100010011001000110010001001100010010001101001010101111001101101010"
             "11010101100110100010101010000010101110111011101111001100110011001101")

SIB9_VAL = {"hnb_name": b"srs-1"}
SIB9_BITS = "010001000111001101110010011100110010110100110001"

SIB13_VAL = {
    "mbsfn_area_info_list": [{
        "mbsfn_area_id": 3,
        "non_mbsfn_region_length": "s2",
        "notification_indicator": 0,
        "mcch_config": {
            "mcch_repetition_period": "rf64",
            "mcch_offset": 5,
            "mcch_modification_period": "rf512",
            "sf_alloc_info": 0x20,
            "signalling_mcs": "n7",
        },
    }],
    "notification_config": {
        "notification_repetition_coeff": "n2",
        "notification_offset": 0,
        "notification_sf_index": 1,
    },
}
SIB13_BITS = "00000000000011100001010101000000100000000"


class TestSibParity:
    def test_sib4(self):
        assert bits_of(M.SystemInformationBlockType4, SIB4A_VAL) == SIB4A_BITS
        assert bits_of(M.SystemInformationBlockType4, SIB4B_VAL) == SIB4B_BITS

    def test_sib5(self):
        assert bits_of(M.SystemInformationBlockType5, SIB5_VAL) == SIB5_BITS

    def test_sib6(self):
        assert bits_of(M.SystemInformationBlockType6, SIB6_VAL) == SIB6_BITS

    def test_sib7(self):
        assert bits_of(M.SystemInformationBlockType7, SIB7_VAL) == SIB7_BITS

    def test_sib8(self):
        assert bits_of(M.SystemInformationBlockType8, SIB8_VAL) == SIB8_BITS

    def test_sib9(self):
        assert bits_of(M.SystemInformationBlockType9, SIB9_VAL) == SIB9_BITS

    def test_sib13(self):
        assert bits_of(M.SystemInformationBlockType13_r9, SIB13_VAL) \
            == SIB13_BITS


class TestSibRoundtrip:
    def _rt(self, typ, val):
        out = roundtrip(typ, val)
        # unpack fills absent optionals with None; compare present keys
        def cmp(a, b):
            if isinstance(a, dict):
                for k, v in a.items():
                    cmp(v, b[k])
            elif isinstance(a, (list, tuple)) and not isinstance(a, bytes):
                assert len(a) == len(b)
                for x, y in zip(a, b):
                    cmp(x, y)
            else:
                assert a == b
        cmp(val, out)

    def test_roundtrips(self):
        for typ, val in [
            (M.SystemInformationBlockType4, SIB4A_VAL),
            (M.SystemInformationBlockType4, SIB4B_VAL),
            (M.SystemInformationBlockType5, SIB5_VAL),
            (M.SystemInformationBlockType6, SIB6_VAL),
            (M.SystemInformationBlockType7, SIB7_VAL),
            (M.SystemInformationBlockType8, SIB8_VAL),
            (M.SystemInformationBlockType9, SIB9_VAL),
            (M.SystemInformationBlockType10, {
                "message_identifier": 0x1100, "serial_number": 0x3001,
                "warning_type": b"\x01\x02"}),
            (M.SystemInformationBlockType11, {
                "message_identifier": 0x1101, "serial_number": 0x3002,
                "warning_message_segment_type": "lastSegment",
                "warning_message_segment_number": 2,
                "warning_message_segment": b"hello warning",
                "data_coding_scheme": b"\x0f"}),
            (M.SystemInformationBlockType12_r9, {
                "message_identifier": 0x1112, "serial_number": 0x3003,
                "warning_message_segment_type": "notLastSegment",
                "warning_message_segment_number": 0,
                "warning_message_segment": b"cmas"}),
            (M.SystemInformationBlockType13_r9, SIB13_VAL),
        ]:
            self._rt(typ, val)


class TestSiContainer:
    # oracle SI_MSG: SystemInformation([sib4, sib13]) as the reference
    # packs it (126 bits; under-padded open type, see module docstring)
    REF_SI_MSG = ("00000010001001100001000110010101111011001010101001000010"
                  "01001101000110000001000001100000000000001110000101010100"
                  "00001000000000")

    def test_matches_reference_up_to_padding(self):
        """[sib4, sib13]: bit-exact vs the oracle through the open-type
        content; only the trailing pad differs (ours is conformant)."""
        si = {"critical_extensions": ("systemInformation_r8", {
            "sib_type_and_info": [("sib4", SIB4A_VAL),
                                  ("sib13_v920", SIB13_VAL)]})}
        ours = bits_of(M.SystemInformation, si)
        cut = len(self.REF_SI_MSG) - 1          # ref carries 1 pad bit
        assert ours[:cut] == self.REF_SI_MSG[:cut]
        assert len(ours) == cut + 7             # ours pads to the 6 octets

    def test_extension_sib_roundtrip(self):
        """[sib4, sib13] through the extended choice (X.691-conformant
        open type; see module docstring for the reference's padding bug)."""
        si = {"critical_extensions": ("systemInformation_r8", {
            "sib_type_and_info": [("sib4", SIB4A_VAL),
                                  ("sib13_v920", SIB13_VAL)]})}
        w = BitWriter()
        M.SystemInformation.pack(w, si)
        out = M.SystemInformation.unpack(BitReader(w.to_bytes(), len(w)))
        lst = out["critical_extensions"][1]["sib_type_and_info"]
        assert lst[0][0] == "sib4" and lst[1][0] == "sib13_v920"
        assert lst[1][1]["mbsfn_area_info_list"][0]["mbsfn_area_id"] == 3
        # open type header: ext bit + 7-bit index + 8-bit length(6 octets)
        body = "".join(str(b) for b in w.bits)
        idx = len("0000001" + "00010" + SIB4A_BITS)
        assert body[idx:idx + 16] == "1" + "0000001" + "00000110"
        # content padded to the declared 6 octets (unlike the reference)
        assert len(body) - (idx + 16) == 48

    def test_unknown_extension_passthrough(self):
        """An unrecognised addition index round-trips verbatim."""
        raw = bytes([0xAA, 0xBB])
        si = {"critical_extensions": ("systemInformation_r8", {
            "sib_type_and_info": [("_ext5", raw)]})}
        out = roundtrip(M.SystemInformation, si)
        assert out["critical_extensions"][1]["sib_type_and_info"][0] \
            == ("_ext5", raw)
