"""The plain reference of the benchmark: the published models in plain
PyTorch and NumPy (cv2 for the host crop, as the original preprocessing
has it), written from the architectures' descriptions. It imports
nothing of the program under test and takes from the benchmark only what
the benchmark made itself: the weights' state dict, the SMPL tensors, the
frames and the boxes."""
