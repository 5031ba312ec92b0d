"""The plain reference that decides ``correct``: the scene, its tables, the
camera and every path worked out again from the configuration file, in
plain numpy and PyTorch. It imports nothing of the program (the port,
``raytracing_tpu_torch``) and nothing of JAX.

Frozen copies of raytracing_tpu_torch at commit a1403821e8fd; each
module's header names the functions it copies and their files."""
