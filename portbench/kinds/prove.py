"""Kind "prove": one in-process prover of the configuration's circuit
(portbench/circuits/<circuit>.py), warm, proving a pool of distinct
witnesses in turn (closed loop, one client): `api.SetupForProver.prove`,
with the configuration's key form and transcript.  The proofs drawn from
the seed (one in the mix's `judge_every`) are judged by the reference's
verifier (reference/plonk.py) against the verification key that it works
out again from the circuit and the key's tau.  The control proves with the
program's other transcript, rescue: the configuration's keccak is the
guarantee it breaks.

Mix parameters: `pool` (witnesses), `warmup` (proofs of another witness
at set-up), `judge_every`.  Configuration: `circuit`, `domain_log2`,
`key_form` ("monomial" or "lagrange"), `transcript`."""

from portbench import workload
from portbench.reference import plonk


class Work:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 control: bool = False):
        self.config, self.traffic, self.seed, self.device = config, traffic, seed, device
        self.circuit = workload.load("circuits", config["circuit"])
        self.transcript = "rescue" if control else config["transcript"]
        self.tau = workload.seeded_tau(seed, 0)

    def setup(self) -> None:
        from plonkit_tpu_torch.api import SetupForProver, crs_lagrange_form
        from plonkit_tpu_torch.frontend.circuit import CircomCircuit
        from plonkit_tpu_torch.frontend.r1cs import R1CS
        inputs, wires, self.constraints = self.circuit.r1cs(self.config)
        r1cs = R1CS(num_inputs=inputs, num_aux=wires - inputs, num_variables=wires,
                    constraints=self.constraints)
        log2 = self.config["domain_log2"]
        key = workload.device_key(log2, self.tau, self.device)
        lagrange = None
        if self.config["key_form"] == "lagrange":
            lagrange = crs_lagrange_form(key, 1 << log2, device=self.device)
        elif self.config["key_form"] != "monomial":
            raise ValueError(f"key form {self.config['key_form']!r}")
        self.witnesses = [self.circuit.witness(self.config, self.seed, j)
                          for j in range(self.traffic["pool"])]
        self.circuits = [CircomCircuit(r1cs=r1cs, witness=w) for w in self.witnesses]
        self.prover = SetupForProver(self.circuits[0], key, key_lagrange_form=lagrange,
                                     device=self.device)
        if self.prover.setup_polynomials.domain_size != 1 << log2:
            raise ValueError(f"the circuit's domain is "
                             f"{self.prover.setup_polynomials.domain_size}, not 2^{log2}")
        warm = CircomCircuit(r1cs=r1cs, witness=self.circuit.witness(self.config, self.seed, -1))
        for _ in range(self.traffic["warmup"]):
            self.prover.prove(warm, transcript=self.transcript)

    def request(self, i: int):
        return self.prover.prove(self.circuits[i % len(self.circuits)],
                                 transcript=self.transcript)

    def keep(self, i: int, proof):
        return proof if workload.drawn(self.seed, i, self.traffic["judge_every"]) else None

    def release(self) -> None:
        self.prover = self.circuits = None
        workload.free(self.device)

    def judge(self, kept: list) -> tuple:
        """({"proofs_rejected": (proofs the verifier refused, 0)}, that count)."""
        inputs, wires, _ = self.circuit.r1cs(self.config)
        vk = plonk.verification_key(plonk.transpile(inputs, wires, self.constraints), self.tau)
        rejected = 0
        for i, proof in kept:
            public = self.circuit.public(self.witnesses[i % len(self.witnesses)])
            if not plonk.verify(vk, self.tau, public, proof):
                rejected += 1
        return {"proofs_rejected": (rejected, 0)}, rejected
