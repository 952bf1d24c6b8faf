"""Host-side helpers of the display and scanner: numpy-only copies of
``sdrpp_tpu.misc``'s meters, waterfall and scanner."""
