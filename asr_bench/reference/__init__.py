"""The benchmark's plain reference of the joint CTC/attention recogniser.

Plain PyTorch (cuDNN's LSTM and convolutions, ``torch.fft``), written from
the recipe's layer equations. It imports nothing of the program under test
and takes nothing the program made: the harness hands it the weights it drew
from the seed, the raw int16 waves and token ids of its own traffic, the
seeds of each step's random stream, and, to be judged, the program's outputs.
"""
