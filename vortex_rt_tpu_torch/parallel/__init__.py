"""Multi-device rendering on ``torch.distributed``: image row blocks
(``tiles``) and scene shards (``shards``) over a mesh of ranks
(``mesh``), and a launcher of ranks on one host (``launch``)."""
