"""Model families of the port (counterpart of ``k8s_dra_driver_tpu.models``)."""
