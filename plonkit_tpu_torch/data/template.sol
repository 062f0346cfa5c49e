// SPDX-License-Identifier: MIT OR Apache-2.0
//
// PLONK verifier for the width-4 + D-next gate system, generated by
// plonkit_tpu `generate-verifier`.  Written from scratch against the
// protocol spec implemented in plonkit_tpu/plonk/verifier.py; exposes the
// same external ABI as the classic bellman_vk_codegen verifier:
//
//   verify_serialized_proof(uint256[] public_inputs, uint256[33] proof)
//
// Gate equation:
//   q_a*a + q_b*b + q_c*c + q_d*d + q_m*a*b + q_const + q_d_next*d(X*omega) = 0

pragma solidity >=0.6.0 <0.9.0;

contract KeyedVerifier {
    uint256 constant r_mod = 21888242871839275222246405745257275088548364400416034343698204186575808495617;
    uint256 constant q_mod = 21888242871839275222246405745257275088696311157297823662689037894645226208583;
    uint256 constant SERIALIZED_PROOF_LENGTH = 33;
    uint256 constant STATE_WIDTH = 4;
    uint256 constant FR_MASK = 0x1fffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff;

    // ---------------------------------------------------------------- Fr ops

    function fr_add(uint256 a, uint256 b) internal pure returns (uint256) {
        return addmod(a, b, r_mod);
    }

    function fr_sub(uint256 a, uint256 b) internal pure returns (uint256) {
        return addmod(a, r_mod - b, r_mod);
    }

    function fr_mul(uint256 a, uint256 b) internal pure returns (uint256) {
        return mulmod(a, b, r_mod);
    }

    function fr_pow(uint256 base, uint256 e) internal view returns (uint256 result) {
        uint256[6] memory input = [uint256(32), 32, 32, base, e, r_mod];
        uint256[1] memory out;
        bool ok;
        assembly {
            ok := staticcall(gas(), 0x05, input, 0xc0, out, 0x20)
        }
        require(ok, "modexp failed");
        result = out[0];
    }

    function fr_inv(uint256 a) internal view returns (uint256) {
        require(a != 0, "inverse of zero");
        return fr_pow(a, r_mod - 2);
    }

    // ---------------------------------------------------------------- G1 ops

    struct G1 {
        uint256 x;
        uint256 y;
    }

    function g1_check(uint256 x, uint256 y) internal pure returns (G1 memory) {
        if (x == 0 && y == 0) {
            return G1(0, 0); // point at infinity
        }
        require(x < q_mod && y < q_mod, "coordinate out of range");
        require(
            mulmod(y, y, q_mod) ==
                addmod(mulmod(mulmod(x, x, q_mod), x, q_mod), 3, q_mod),
            "point not on curve"
        );
        return G1(x, y);
    }

    function g1_add(G1 memory p, G1 memory q) internal view returns (G1 memory r) {
        if (p.x == 0 && p.y == 0) return G1(q.x, q.y);
        if (q.x == 0 && q.y == 0) return G1(p.x, p.y);
        uint256[4] memory input = [p.x, p.y, q.x, q.y];
        bool ok;
        assembly {
            ok := staticcall(gas(), 0x06, input, 0x80, r, 0x40)
        }
        require(ok, "ec add failed");
    }

    function g1_sub(G1 memory p, G1 memory q) internal view returns (G1 memory) {
        if (q.x == 0 && q.y == 0) return G1(p.x, p.y);
        return g1_add(p, G1(q.x, q_mod - q.y));
    }

    function g1_mul(G1 memory p, uint256 s) internal view returns (G1 memory r) {
        uint256[3] memory input = [p.x, p.y, s];
        bool ok;
        assembly {
            ok := staticcall(gas(), 0x07, input, 0x60, r, 0x40)
        }
        require(ok, "ec mul failed");
    }

    function g1_neg(G1 memory p) internal pure returns (G1 memory) {
        if (p.y == 0) {
            require(p.x == 0, "bad point");
            return p;
        }
        return G1(p.x, q_mod - p.y);
    }

    // pairing check: e(a1, [1]_2) * e(b1, [x]_2) == 1
    function pairing_check(G1 memory a1, G1 memory b1) internal view returns (bool) {
        uint256[12] memory input;
        input[0] = a1.x;
        input[1] = a1.y;
        // G2 generator (c1 || c0 encoding expected by the precompile)
        input[2] = 11559732032986387107991004021392285783925812861821192530917403151452391805634;
        input[3] = 10857046999023057135944570762232829481370756359578518086990519993285655852781;
        input[4] = 4082367875863433681332203403145435568316851327593401208105741076214120093531;
        input[5] = 8495653923123431417604973247489272438418190587263600148770280649306958101930;
        input[6] = b1.x;
        input[7] = b1.y;
        input[8] = {{g2_x_x_c1}};
        input[9] = {{g2_x_x_c0}};
        input[10] = {{g2_x_y_c1}};
        input[11] = {{g2_x_y_c0}};
        uint256[1] memory out;
        bool ok;
        assembly {
            ok := staticcall(gas(), 0x08, input, 0x180, out, 0x20)
        }
        require(ok, "pairing failed");
        return out[0] != 0;
    }

    // ----------------------------------------------------- rolling transcript

    struct Transcript {
        bytes32 s0;
        bytes32 s1;
        uint32 counter;
    }

    function t_update(Transcript memory t, uint256 value) internal pure {
        bytes32 old0 = t.s0;
        bytes32 old1 = t.s1;
        t.s0 = keccak256(abi.encodePacked(uint32(0), old0, old1, value));
        t.s1 = keccak256(abi.encodePacked(uint32(1), old0, old1, value));
    }

    function t_update_point(Transcript memory t, G1 memory p) internal pure {
        t_update(t, p.x);
        t_update(t, p.y);
    }

    function t_challenge(Transcript memory t) internal pure returns (uint256) {
        bytes32 q = keccak256(abi.encodePacked(uint32(2), t.s0, t.s1, t.counter));
        t.counter += 1;
        return uint256(q) & FR_MASK;
    }

    // ------------------------------------------------------------------- vk

    struct Vk {
        uint256 domain_size;
        uint256 num_inputs;
        uint256 omega;
        G1[6] q;            // q_a q_b q_c q_d q_m q_const
        G1 q_d_next;
        G1[4] sigma;
        uint256[3] k;       // permutation non-residues
    }

    function load_vk() internal pure returns (Vk memory vk) {
        vk.domain_size = {{domain_size}};
        vk.num_inputs = {{num_inputs}};
        vk.omega = {{omega}};
        vk.q[0] = G1({{selector_commitment_0_0}}, {{selector_commitment_0_1}});
        vk.q[1] = G1({{selector_commitment_1_0}}, {{selector_commitment_1_1}});
        vk.q[2] = G1({{selector_commitment_2_0}}, {{selector_commitment_2_1}});
        vk.q[3] = G1({{selector_commitment_3_0}}, {{selector_commitment_3_1}});
        vk.q[4] = G1({{selector_commitment_4_0}}, {{selector_commitment_4_1}});
        vk.q[5] = G1({{selector_commitment_5_0}}, {{selector_commitment_5_1}});
        vk.q_d_next = G1({{next_step_selector_commitment_0_0}}, {{next_step_selector_commitment_0_1}});
        vk.sigma[0] = G1({{permutation_commitment_0_0}}, {{permutation_commitment_0_1}});
        vk.sigma[1] = G1({{permutation_commitment_1_0}}, {{permutation_commitment_1_1}});
        vk.sigma[2] = G1({{permutation_commitment_2_0}}, {{permutation_commitment_2_1}});
        vk.sigma[3] = G1({{permutation_commitment_3_0}}, {{permutation_commitment_3_1}});
        vk.k[0] = {{permutation_non_residue_0}};
        vk.k[1] = {{permutation_non_residue_1}};
        vk.k[2] = {{permutation_non_residue_2}};
    }

    // ---------------------------------------------------------------- proof

    struct ProofData {
        uint256[] inputs;
        G1[4] wires;        // [a]_1 [b]_1 [c]_1 [d]_1
        G1 z;               // grand product
        G1[4] t;            // quotient chunks
        uint256[4] wire_at_z;
        uint256 d_at_zw;
        uint256 z_at_zw;
        uint256 t_at_z;
        uint256 r_at_z;
        uint256[3] sigma_at_z;
        G1 w_z;             // opening at zeta
        G1 w_zw;            // opening at zeta*omega
    }

    function parse_proof(uint256[] memory public_inputs, uint256[] memory s)
        internal pure returns (ProofData memory p)
    {
        require(s.length == SERIALIZED_PROOF_LENGTH, "bad proof length");
        p.inputs = public_inputs;
        uint256 j = 0;
        for (uint256 i = 0; i < STATE_WIDTH; i++) {
            p.wires[i] = g1_check(s[j], s[j + 1]);
            j += 2;
        }
        p.z = g1_check(s[j], s[j + 1]);
        j += 2;
        for (uint256 i = 0; i < STATE_WIDTH; i++) {
            p.t[i] = g1_check(s[j], s[j + 1]);
            j += 2;
        }
        for (uint256 i = 0; i < STATE_WIDTH; i++) {
            require(s[j] < r_mod, "eval out of range");
            p.wire_at_z[i] = s[j];
            j += 1;
        }
        require(s[j] < r_mod && s[j + 1] < r_mod && s[j + 2] < r_mod && s[j + 3] < r_mod, "eval range");
        p.d_at_zw = s[j];
        p.z_at_zw = s[j + 1];
        p.t_at_z = s[j + 2];
        p.r_at_z = s[j + 3];
        j += 4;
        for (uint256 i = 0; i < 3; i++) {
            require(s[j] < r_mod, "sigma range");
            p.sigma_at_z[i] = s[j];
            j += 1;
        }
        p.w_z = g1_check(s[j], s[j + 1]);
        p.w_zw = g1_check(s[j + 2], s[j + 3]);
    }

    // ------------------------------------------------------------ challenges

    struct Challenges {
        uint256 beta;
        uint256 gamma;
        uint256 alpha;
        uint256 zeta;
        uint256 v;
        uint256 u;
    }

    function derive_challenges(ProofData memory p) internal pure returns (Challenges memory ch) {
        Transcript memory t;
        for (uint256 i = 0; i < p.inputs.length; i++) {
            t_update(t, p.inputs[i]);
        }
        for (uint256 i = 0; i < STATE_WIDTH; i++) {
            t_update_point(t, p.wires[i]);
        }
        ch.beta = t_challenge(t);
        ch.gamma = t_challenge(t);
        t_update_point(t, p.z);
        ch.alpha = t_challenge(t);
        for (uint256 i = 0; i < STATE_WIDTH; i++) {
            t_update_point(t, p.t[i]);
        }
        ch.zeta = t_challenge(t);
        for (uint256 i = 0; i < STATE_WIDTH; i++) {
            t_update(t, p.wire_at_z[i]);
        }
        t_update(t, p.d_at_zw);
        for (uint256 i = 0; i < 3; i++) {
            t_update(t, p.sigma_at_z[i]);
        }
        t_update(t, p.t_at_z);
        t_update(t, p.r_at_z);
        t_update(t, p.z_at_zw);
        ch.v = t_challenge(t);
        t_update_point(t, p.w_z);
        t_update_point(t, p.w_zw);
        ch.u = t_challenge(t);
    }

    // ------------------------------------------------------------ the checks

    // L_i(zeta) for i in 0..num_inputs
    function lagrange_at_zeta(Vk memory vk, uint256 zeta)
        internal view returns (uint256[] memory evals, uint256 vanishing)
    {
        vanishing = fr_sub(fr_pow(zeta, vk.domain_size), 1);
        require(vanishing != 0, "zeta in domain");
        evals = new uint256[](vk.num_inputs);
        uint256 w = 1;
        for (uint256 i = 0; i < vk.num_inputs; i++) {
            // L_i(z) = w^i (z^n - 1) / (n (z - w^i))
            uint256 den = fr_mul(fr_sub(zeta, w), vk.domain_size);
            evals[i] = fr_mul(fr_mul(w, vanishing), fr_inv(den));
            w = fr_mul(w, vk.omega);
        }
    }

    function check_gate_identity(
        Vk memory vk,
        ProofData memory p,
        Challenges memory ch,
        uint256[] memory lag,
        uint256 vanishing
    ) internal pure returns (bool) {
        uint256 lhs = fr_mul(vanishing, p.t_at_z);
        uint256 rhs = p.r_at_z;
        for (uint256 i = 0; i < p.inputs.length; i++) {
            rhs = fr_add(rhs, fr_mul(lag[i], p.inputs[i]));
        }
        uint256 zpart = p.z_at_zw;
        for (uint256 i = 0; i < 3; i++) {
            zpart = fr_mul(
                zpart,
                fr_add(fr_add(fr_mul(p.sigma_at_z[i], ch.beta), ch.gamma), p.wire_at_z[i])
            );
        }
        zpart = fr_mul(zpart, fr_add(ch.gamma, p.wire_at_z[3]));
        rhs = fr_sub(rhs, fr_mul(zpart, ch.alpha));
        rhs = fr_sub(rhs, fr_mul(lag[0], fr_mul(ch.alpha, ch.alpha)));
        return lhs == rhs;
    }

    // reconstruct v*[r]_1 + (v^9 u)*[z]_1 (the commitment the linearization
    // and shifted-z openings contribute to the batched KZG check)
    function reconstruct_d(
        Vk memory vk,
        ProofData memory p,
        Challenges memory ch,
        uint256 l0_at_z
    ) internal view returns (G1 memory d) {
        d = G1(vk.q[5].x, vk.q[5].y);
        for (uint256 i = 0; i < STATE_WIDTH; i++) {
            d = g1_add(d, g1_mul(vk.q[i], p.wire_at_z[i]));
        }
        d = g1_add(d, g1_mul(vk.q[4], fr_mul(p.wire_at_z[0], p.wire_at_z[1])));
        d = g1_add(d, g1_mul(vk.q_d_next, p.d_at_zw));

        uint256 zcoef = fr_add(fr_add(fr_mul(ch.zeta, ch.beta), p.wire_at_z[0]), ch.gamma);
        for (uint256 i = 0; i < 3; i++) {
            zcoef = fr_mul(
                zcoef,
                fr_add(
                    fr_add(fr_mul(fr_mul(ch.zeta, vk.k[i]), ch.beta), ch.gamma),
                    p.wire_at_z[i + 1]
                )
            );
        }
        zcoef = fr_mul(zcoef, ch.alpha);
        zcoef = fr_add(zcoef, fr_mul(l0_at_z, fr_mul(ch.alpha, ch.alpha)));

        uint256 scoef = 1;
        for (uint256 i = 0; i < 3; i++) {
            scoef = fr_mul(
                scoef,
                fr_add(fr_add(fr_mul(ch.beta, p.sigma_at_z[i]), ch.gamma), p.wire_at_z[i])
            );
        }
        scoef = fr_mul(fr_mul(fr_mul(scoef, ch.beta), p.z_at_zw), ch.alpha);

        d = g1_add(d, g1_sub(g1_mul(p.z, zcoef), g1_mul(vk.sigma[3], scoef)));
        d = g1_mul(d, ch.v);
        // v^9 * u * [z]_1 for the z(zeta*omega) opening
        uint256 v9u = fr_mul(fr_pow(ch.v, 9), ch.u);
        d = g1_add(d, g1_mul(p.z, v9u));
    }

    function check_openings(
        Vk memory vk,
        ProofData memory p,
        Challenges memory ch,
        G1 memory d
    ) internal view returns (bool) {
        uint256 zn = fr_pow(ch.zeta, vk.domain_size);

        // aggregate commitments with powers of v
        G1 memory agg = G1(p.t[0].x, p.t[0].y);
        uint256 pw = 1;
        for (uint256 i = 1; i < STATE_WIDTH; i++) {
            pw = fr_mul(pw, zn);
            agg = g1_add(agg, g1_mul(p.t[i], pw));
        }
        agg = g1_add(agg, d); // carries v*[r] and v^9 u*[z]
        uint256 vc = ch.v;
        for (uint256 i = 0; i < STATE_WIDTH; i++) {
            vc = fr_mul(vc, ch.v);
            agg = g1_add(agg, g1_mul(p.wires[i], vc));
        }
        for (uint256 i = 0; i < 3; i++) {
            vc = fr_mul(vc, ch.v);
            agg = g1_add(agg, g1_mul(vk.sigma[i], vc));
        }
        vc = fr_mul(vc, ch.v);            // v^9 consumed inside d
        vc = fr_mul(vc, ch.v);            // v^10 for the shifted d-wire
        agg = g1_add(agg, g1_mul(p.wires[3], fr_mul(vc, ch.u)));

        // aggregate claimed values with the same powers
        uint256 val = p.t_at_z;
        uint256 vv = ch.v;
        val = fr_add(val, fr_mul(p.r_at_z, vv));
        for (uint256 i = 0; i < STATE_WIDTH; i++) {
            vv = fr_mul(vv, ch.v);
            val = fr_add(val, fr_mul(p.wire_at_z[i], vv));
        }
        for (uint256 i = 0; i < 3; i++) {
            vv = fr_mul(vv, ch.v);
            val = fr_add(val, fr_mul(p.sigma_at_z[i], vv));
        }
        vv = fr_mul(vv, ch.v);
        val = fr_add(val, fr_mul(fr_mul(p.z_at_zw, vv), ch.u));
        vv = fr_mul(vv, ch.v);
        val = fr_add(val, fr_mul(fr_mul(p.d_at_zw, vv), ch.u));

        agg = g1_sub(agg, g1_mul(G1(1, 2), val));

        G1 memory with_gen = g1_add(agg, g1_mul(p.w_z, ch.zeta));
        with_gen = g1_add(
            with_gen,
            g1_mul(p.w_zw, fr_mul(fr_mul(ch.zeta, vk.omega), ch.u))
        );
        G1 memory with_x = g1_neg(g1_add(g1_mul(p.w_zw, ch.u), p.w_z));
        return pairing_check(with_gen, with_x);
    }

    function verify(ProofData memory p, Vk memory vk) internal view returns (bool) {
        require(p.inputs.length == vk.num_inputs, "input count mismatch");
        require(vk.num_inputs >= 1, "no inputs");
        Challenges memory ch = derive_challenges(p);
        (uint256[] memory lag, uint256 vanishing) = lagrange_at_zeta(vk, ch.zeta);
        if (!check_gate_identity(vk, p, ch, lag, vanishing)) {
            return false;
        }
        G1 memory d = reconstruct_d(vk, p, ch, lag[0]);
        return check_openings(vk, p, ch, d);
    }

    function verify_serialized_proof(
        uint256[] memory public_inputs,
        uint256[] memory serialized_proof
    ) public view returns (bool) {
        Vk memory vk = load_vk();
        require(vk.num_inputs == public_inputs.length, "bad inputs");
        ProofData memory proof = parse_proof(public_inputs, serialized_proof);
        return verify(proof, vk);
    }
}
