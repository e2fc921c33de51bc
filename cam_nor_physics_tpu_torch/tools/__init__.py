"""The repo's long runs on the port: the Held-Suarez climatology with the
HS94 structure checks (`hs_climate`) and the JW06 baroclinic wave
(`jw_baroclinic`, `jw06_envelope`). Twins of the JAX package's
tools/hs_climate.py and tools/jw_baroclinic.py and of the nine-day JW06
envelope of tests/test_baroclinic_wave.py."""
