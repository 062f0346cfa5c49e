from .r1cs import R1CS, load_r1cs
from .witness import load_witness
from .circuit import CircomCircuit
