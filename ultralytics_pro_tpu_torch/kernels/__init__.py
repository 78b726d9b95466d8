"""Hand-written CUDA kernels of the port, built with nvcc and bound with ctypes.

| kernel | replaces (TPU kernel) | source | wrapper |
| K1 greedy NMS | ultralytics_pro_tpu/kernels/nms_pallas.py:pallas_greedy_nms | csrc/greedy_nms.cu | kernels/nms_cuda.py |
| K2 deformable-attention sampling | ultralytics_pro_tpu/kernels/msda_pallas.py:msda_sample_pallas (and the msda_flatten_coords it is fed) | csrc/msda_sample.cu | kernels/msda_cuda.py |
"""
