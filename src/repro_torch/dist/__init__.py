"""Distribution helpers of the port: the logical-axis sharding rules over
DTensor (``sharding``), which make checkpoints elastic
(``ckpt.elastic``) and the dry run mesh-agnostic (``launch.specs``), and
int8 gradient compression with error feedback (``compression``)."""
