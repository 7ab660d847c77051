"""Scale-out (port of ``fastdem_tpu/parallel``): block-sharded GLOBAL maps
over a mesh of blocks (``sharding``) and the multi-process runtime with
its sharded npz checkpoint and scaling report (``distributed``)."""
