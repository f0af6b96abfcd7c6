"""Channel processors and full UE/eNB chains.

Batched counterpart of the reference's lib/src/phy/phch (PDSCH, PDCCH,
PBCH, ...), lib/src/phy/ue (ue_dl, ue_sync) and lib/src/phy/enb (enb_dl,
enb_ul) layers: statically-configured, batched subframe processors
composed from the ops/ kernels.
"""
