"""Ops with hand-written CUDA kernels; importing builds nothing.

Import from the submodules (``ops.group_norm``, ``ops.attention``,
``ops.flash_attention``, ``ops.gn_kernels``, ``ops.adaln_norm``,
``ops.residual_bias``): their function names equal module names, so this
package re-exports nothing.
``ops.routes`` routes them through their plain versions and reads their
launch counters.
"""
