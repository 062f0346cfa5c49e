// SPDX-License-Identifier: MIT OR Apache-2.0
//
// Recursive (aggregated) PLONK verifier, generated by plonkit_tpu
// `generate-recursive-verifier`.  Written from scratch against the
// extended-gate-system spec implemented in plonkit_tpu/plonk/extended.py
// (width-4 + D-next main gate PLUS the two-bit-decomposition range custom
// gate) and the aggregation statement in
// plonkit_tpu/recursive/aggregation.py.  Role parity with the reference's
// solidity_recursive_plonk_verifier output (SURVEY D5):
//
//   verifyAggregatedProof(aggr_limbs, vk_root, individual_inputs, proof)
//
// The single public input of the outer proof is
//   rescue(vk_root || individual_inputs || aggr_limbs)
// recomputed on-chain; rescue round constants are re-derived from the
// keccak counter stream they were generated with (zero code-size cost),
// and the aggregated pairing pair is rebuilt from its 68-bit limbs and
// pairing-checked -- the contract mirror of verify_aggregation().

pragma solidity >=0.6.0 <0.9.0;

contract KeysWithPlonkVerifier {
    uint256 constant r_mod = 21888242871839275222246405745257275088548364400416034343698204186575808495617;
    uint256 constant q_mod = 21888242871839275222246405745257275088696311157297823662689037894645226208583;
    uint256 constant SERIALIZED_PROOF_LENGTH = 33;
    uint256 constant STATE_WIDTH = 4;
    uint256 constant FR_MASK = 0x1fffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff;
    uint256 constant LIMB_BITS = 68;
    uint256 constant NUM_AGGR_LIMBS = 16;
    uint256 constant INDIVIDUAL_INPUTS = {{individual_inputs}};

    // rescue shape (mirrors plonkit_tpu/recursive/rescue.py)
    uint256 constant RESCUE_ROUNDS = 22;
    uint256 constant RESCUE_ALPHA_INV = {{rescue_alpha_inv}};

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

    // --------------------------------------------------------------- rescue
    // Algebraic sponge over Fr: width 3, rate 2, 22 rounds, s-box x^5 /
    // x^(1/5).  Round constants and the Cauchy MDS matrix are baked as
    // literals: they come from franklin-crypto's Blake2s/ChaCha generation
    // procedure (recursive/franklin.py), which has no EVM builtin.

    function rescue_round_constants() internal pure returns (uint256[3][45] memory rc) {
{{rescue_round_constants_body}}
    }

    function rescue_mds() internal pure returns (uint256[3][3] memory m) {
        m[0][0] = {{mds_0_0}};
        m[0][1] = {{mds_0_1}};
        m[0][2] = {{mds_0_2}};
        m[1][0] = {{mds_1_0}};
        m[1][1] = {{mds_1_1}};
        m[1][2] = {{mds_1_2}};
        m[2][0] = {{mds_2_0}};
        m[2][1] = {{mds_2_1}};
        m[2][2] = {{mds_2_2}};
    }

    function rescue_permutation(
        uint256[3] memory s,
        uint256[3][45] memory rc,
        uint256[3][3] memory mds
    ) internal view returns (uint256[3] memory) {
        for (uint256 j = 0; j < 3; j++) {
            s[j] = fr_add(s[j], rc[0][j]);
        }
        for (uint256 rnd = 0; rnd < 2 * RESCUE_ROUNDS; rnd++) {
            if (rnd % 2 == 0) {
                for (uint256 j = 0; j < 3; j++) {
                    s[j] = fr_pow(s[j], RESCUE_ALPHA_INV);
                }
            } else {
                for (uint256 j = 0; j < 3; j++) {
                    uint256 x2 = fr_mul(s[j], s[j]);
                    s[j] = fr_mul(fr_mul(x2, x2), s[j]);
                }
            }
            uint256[3] memory nxt;
            for (uint256 i = 0; i < 3; i++) {
                uint256 acc = rc[rnd + 1][i];
                for (uint256 j = 0; j < 3; j++) {
                    acc = fr_add(acc, fr_mul(mds[i][j], s[j]));
                }
                nxt[i] = acc;
            }
            s = nxt;
        }
        return s;
    }

    function rescue_hash(uint256[] memory inputs) internal view returns (uint256) {
        uint256[3][45] memory rc = rescue_round_constants();
        uint256[3][3] memory mds = rescue_mds();
        uint256 n = inputs.length;
        uint256 padded = n % 2 == 1 ? n + 1 : n;
        uint256[3] memory state;
        state[2] = n; // franklin sponge_fixed_length: capacity = input length
        for (uint256 i = 0; i < padded; i += 2) {
            uint256 b0 = i < n ? inputs[i] : 1;
            uint256 b1 = i + 1 < n ? inputs[i + 1] : 1;
            state[0] = fr_add(state[0], b0);
            state[1] = fr_add(state[1], b1);
            state = rescue_permutation(state, rc, mds);
        }
        return state[0];
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
    // Extended system: 6 main selectors + q_d_next + q_range + 4 sigmas.

    struct Vk {
        uint256 domain_size;
        uint256 omega;
        G1[6] q;            // q_a q_b q_c q_d q_m q_const
        G1 q_d_next;
        G1 q_range;
        G1[4] sigma;
        uint256[3] k;       // permutation non-residues
    }

    function load_vk() internal pure returns (Vk memory vk) {
        vk.domain_size = {{domain_size}};
        vk.omega = {{omega}};
        vk.q[0] = G1({{selector_commitment_0_0}}, {{selector_commitment_0_1}});
        vk.q[1] = G1({{selector_commitment_1_0}}, {{selector_commitment_1_1}});
        vk.q[2] = G1({{selector_commitment_2_0}}, {{selector_commitment_2_1}});
        vk.q[3] = G1({{selector_commitment_3_0}}, {{selector_commitment_3_1}});
        vk.q[4] = G1({{selector_commitment_4_0}}, {{selector_commitment_4_1}});
        vk.q[5] = G1({{selector_commitment_5_0}}, {{selector_commitment_5_1}});
        vk.q_d_next = G1({{next_step_selector_commitment_0_0}}, {{next_step_selector_commitment_0_1}});
        vk.q_range = G1({{range_selector_commitment_0_0}}, {{range_selector_commitment_0_1}});
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
        uint256 input;      // the single public input (the rescue digest)
        G1[4] wires;
        G1 z;
        G1[4] t;
        uint256[4] wire_at_z;
        uint256 d_at_zw;
        uint256 z_at_zw;
        uint256 t_at_z;
        uint256 r_at_z;
        uint256[3] sigma_at_z;
        G1 w_z;
        G1 w_zw;
    }

    function parse_proof(uint256 public_input, uint256[] memory s)
        internal pure returns (ProofData memory p)
    {
        require(s.length == SERIALIZED_PROOF_LENGTH, "bad proof length");
        p.input = public_input;
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
        uint256 alpha5;
        uint256 alpha6;
        uint256 zeta;
        uint256 v;
        uint256 u;
    }

    function derive_challenges(ProofData memory p) internal pure returns (Challenges memory ch) {
        Transcript memory t;
        t_update(t, p.input);
        for (uint256 i = 0; i < STATE_WIDTH; i++) {
            t_update_point(t, p.wires[i]);
        }
        ch.beta = t_challenge(t);
        ch.gamma = t_challenge(t);
        t_update_point(t, p.z);
        ch.alpha = t_challenge(t);
        uint256 a2 = fr_mul(ch.alpha, ch.alpha);
        ch.alpha5 = fr_mul(fr_mul(a2, a2), ch.alpha);
        ch.alpha6 = fr_mul(ch.alpha5, ch.alpha);
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

    // range-gate terms: sum_{k=1..4} alpha^k * g(e_k), g(e) = e(e-1)(e-2)(e-3)
    function range_terms_at_z(ProofData memory p, uint256 alpha)
        internal pure returns (uint256 total)
    {
        uint256[4] memory es;
        es[0] = fr_sub(p.wire_at_z[2], fr_mul(4, p.wire_at_z[3]));
        es[1] = fr_sub(p.wire_at_z[1], fr_mul(4, p.wire_at_z[2]));
        es[2] = fr_sub(p.wire_at_z[0], fr_mul(4, p.wire_at_z[1]));
        es[3] = fr_sub(p.d_at_zw, fr_mul(4, p.wire_at_z[0]));
        uint256 apow = 1;
        for (uint256 i = 0; i < 4; i++) {
            apow = fr_mul(apow, alpha);
            uint256 t1 = fr_sub(fr_mul(es[i], es[i]), fr_mul(3, es[i]));
            total = fr_add(total, fr_mul(apow, fr_mul(t1, fr_add(t1, 2))));
        }
    }

    function check_gate_identity(
        ProofData memory p,
        Challenges memory ch,
        uint256 l0_at_z,
        uint256 vanishing
    ) internal pure returns (bool) {
        uint256 lhs = fr_mul(vanishing, p.t_at_z);
        uint256 rhs = fr_add(p.r_at_z, fr_mul(l0_at_z, p.input));
        uint256 zpart = p.z_at_zw;
        for (uint256 i = 0; i < 3; i++) {
            zpart = fr_mul(
                zpart,
                fr_add(fr_add(fr_mul(p.sigma_at_z[i], ch.beta), ch.gamma), p.wire_at_z[i])
            );
        }
        zpart = fr_mul(zpart, fr_add(ch.gamma, p.wire_at_z[3]));
        rhs = fr_sub(rhs, fr_mul(zpart, ch.alpha5));
        rhs = fr_sub(rhs, fr_mul(l0_at_z, ch.alpha6));
        return lhs == rhs;
    }

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
        d = g1_add(d, g1_mul(vk.q_range, range_terms_at_z(p, ch.alpha)));

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
        zcoef = fr_mul(zcoef, ch.alpha5);
        zcoef = fr_add(zcoef, fr_mul(l0_at_z, ch.alpha6));

        uint256 scoef = 1;
        for (uint256 i = 0; i < 3; i++) {
            scoef = fr_mul(
                scoef,
                fr_add(fr_add(fr_mul(ch.beta, p.sigma_at_z[i]), ch.gamma), p.wire_at_z[i])
            );
        }
        scoef = fr_mul(fr_mul(fr_mul(scoef, ch.beta), p.z_at_zw), ch.alpha5);

        d = g1_add(d, g1_sub(g1_mul(p.z, zcoef), g1_mul(vk.sigma[3], scoef)));
        d = g1_mul(d, ch.v);
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

        G1 memory agg = G1(p.t[0].x, p.t[0].y);
        uint256 pw = 1;
        for (uint256 i = 1; i < STATE_WIDTH; i++) {
            pw = fr_mul(pw, zn);
            agg = g1_add(agg, g1_mul(p.t[i], pw));
        }
        agg = g1_add(agg, d);
        uint256 vc = ch.v;
        for (uint256 i = 0; i < STATE_WIDTH; i++) {
            vc = fr_mul(vc, ch.v);
            agg = g1_add(agg, g1_mul(p.wires[i], vc));
        }
        for (uint256 i = 0; i < 3; i++) {
            vc = fr_mul(vc, ch.v);
            agg = g1_add(agg, g1_mul(vk.sigma[i], vc));
        }
        vc = fr_mul(vc, ch.v);
        vc = fr_mul(vc, ch.v);
        agg = g1_add(agg, g1_mul(p.wires[3], fr_mul(vc, ch.u)));

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

    function verify_outer(ProofData memory p, Vk memory vk) internal view returns (bool) {
        Challenges memory ch = derive_challenges(p);
        uint256 vanishing = fr_sub(fr_pow(ch.zeta, vk.domain_size), 1);
        require(vanishing != 0, "zeta in domain");
        uint256 l0_at_z = fr_mul(vanishing, fr_inv(fr_mul(fr_sub(ch.zeta, 1), vk.domain_size)));
        if (!check_gate_identity(p, ch, l0_at_z, vanishing)) {
            return false;
        }
        G1 memory d = reconstruct_d(vk, p, ch, l0_at_z);
        return check_openings(vk, p, ch, d);
    }

    // ------------------------------------------------------- aggregate entry

    function reconstruct_limbed_point(uint256[NUM_AGGR_LIMBS] memory limbs, uint256 off)
        internal pure returns (G1 memory)
    {
        uint256 x = 0;
        uint256 y = 0;
        for (uint256 i = 0; i < 4; i++) {
            require(limbs[off + i] < (1 << LIMB_BITS), "limb too wide");
            require(limbs[off + 4 + i] < (1 << LIMB_BITS), "limb too wide");
            x += limbs[off + i] << (LIMB_BITS * i);
            y += limbs[off + 4 + i] << (LIMB_BITS * i);
        }
        return g1_check(x, y);
    }

    function verifyAggregatedProof(
        uint256[NUM_AGGR_LIMBS] memory aggr_limbs,
        uint256 vk_root,
        uint256[] memory individual_inputs,
        uint256[] memory serialized_proof
    ) public view returns (bool) {
        require(individual_inputs.length == INDIVIDUAL_INPUTS, "bad input count");

        // 1. recompute the outer public input
        uint256[] memory preimage = new uint256[](1 + INDIVIDUAL_INPUTS + NUM_AGGR_LIMBS);
        preimage[0] = vk_root;
        for (uint256 i = 0; i < INDIVIDUAL_INPUTS; i++) {
            require(individual_inputs[i] < r_mod, "input range");
            preimage[1 + i] = individual_inputs[i];
        }
        for (uint256 i = 0; i < NUM_AGGR_LIMBS; i++) {
            preimage[1 + INDIVIDUAL_INPUTS + i] = aggr_limbs[i];
        }
        uint256 expected_input = rescue_hash(preimage);

        // 2. verify the outer extended-system proof
        Vk memory vk = load_vk();
        ProofData memory proof = parse_proof(expected_input, serialized_proof);
        if (!verify_outer(proof, vk)) {
            return false;
        }

        // 3. rebuild the aggregated pairing pair from its limbs and check it
        G1 memory pg = reconstruct_limbed_point(aggr_limbs, 0);
        G1 memory px = reconstruct_limbed_point(aggr_limbs, 8);
        require(!(pg.x == 0 && pg.y == 0) && !(px.x == 0 && px.y == 0), "identity aggregate");
        return pairing_check(pg, px);
    }
}
