"""ini config -> ReceiverPlan -> CompiledReceiver (ports of
``sdrreceiver_tpu.graph``)."""
