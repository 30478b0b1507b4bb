"""Pipeline metrics, the plan cost model and the spectrum scope (ports of
``sdrreceiver_tpu.obs``)."""
