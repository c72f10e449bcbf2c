"""Multi-process training of the port: the dp / fsdp / tp mesh as process
groups (`mesh.py`) with FSDP2 over the data-like axes and Megatron tensor
parallelism over the `model` axis (`tensor_parallel.py`), and GPipe pipeline
parallelism over a group of stages (`pipeline.py`)."""
