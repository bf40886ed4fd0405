"""The plain reference runs of the output check, one module per driver.

Each function runs in a process of its own (``refrun``), on the CPU, with
the benchmark's plain filter (``plain_filter``): it imports nothing of the
port, of the JAX package or of JAX, and gets from the harness the inputs
that the port got and, for a step-by-step check, the program's state before
each step.
"""
