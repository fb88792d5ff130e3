"""Freeverb tunings (a copy of ``st_ito_tpu/ops/reverb.py:95-97``; the
time-domain Freeverb itself is ROADMAP §1 item 7)."""

_COMB_TUNINGS = (1116, 1188, 1277, 1356, 1422, 1491, 1557, 1617)  # @44.1 kHz
_ALLPASS_TUNINGS = (556, 441, 341, 225)
_STEREO_SPREAD = 23
