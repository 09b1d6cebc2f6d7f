"""Distributed training pieces of the port: the logical-axis sharding rules
(``context``, ``sharding``), the int8 gradient compression and its
all-reduce (``compression``), over ``torch.distributed`` process groups."""
