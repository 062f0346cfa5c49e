from .r1cs import R1CS, load_r1cs
from .circuit import CircomCircuit
