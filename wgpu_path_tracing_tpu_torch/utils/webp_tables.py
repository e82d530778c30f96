"""The constant tables of the VP8 and VP8L decoders (``utils/webp.py``).

The numbers are the bitstream formats' own: RFC 6386's quantizer lookups
(``dc_qlookup``, ``ac_qlookup``), default coefficient probabilities, their
update probabilities and the B_PRED mode probabilities (in libwebp's order
of the ten modes: DC, TM, VE, HE, RD, VR, LD, VL, HD, HU), and the VP8L
specification's 120-entry distance map, each stored as libwebp stores it
(``kCodeToPlane``: ``(dy << 4) | (8 - dx)``). NumPy views of them are made
once, at import.
"""

import numpy as np

# kDcTable: 128 uint8.
_DC = bytes.fromhex(
    "0405060708090a0a0b0c0d0e0f101111121314141515161617171819191a1b1c1d1e1f20"
    "212223242525262728292a2b2c2d2e2e2f303132333435363738393a3b3c3d3e3f404142"
    "434445464748494a4b4c4c4d4e4f505152535455565758595b5d5f6062646566686a6c6e"
    "707274767a7c7e80828486888a8c8f9194979a9d")
# kAcTable: 128 little-endian uint16.
_AC = bytes.fromhex(
    "0400050006000700080009000a000b000c000d000e000f00100011001200130014001500"
    "16001700180019001a001b001c001d001e001f0020002100220023002400250026002700"
    "280029002a002b002c002d002e002f003000310032003300340035003600370038003900"
    "3a003c003e00400042004400460048004a004c004e00500052005400560058005a005c00"
    "5e00600062006400660068006a006c006e0070007200740077007a007d00800083008600"
    "89008c008f009200950098009b009e00a100a400a700aa00ad00b100b500b900bd00c100"
    "c500c900cd00d100d500d900dd00e100e500ea00ef00f500f900fe00030108010d011201"
    "17011c01")
# CoeffsProba0[4][8][3][11].
_PROBA0 = bytes.fromhex(
    "808080808080808080808080808080808080808080808080808080808080808080fd88fe"
    "ffe4db8080808080bd81f2ffe3d5ffdb8080806a7ee3fcd6d1ffff8080800162f8ffece2"
    "ffff808080b585eefeddeaff9a8080804e86caf7c6b4ffdb80808001b9f9fff3ff808080"
    "8080b896f7ffece080808080804d6ed8ffece680808080800165fbfff1ff8080808080aa"
    "8bf1fcecd1ffff8080802574c4f3e4ffffff80808001ccfefff5ff8080808080cfa0faff"
    "ee8080808080806667e7ffd3ab80808080800198fcfff0ff8080808080b187f3ffeae180"
    "808080805081d3ffc2e080808080800101ff8080808080808080f601ff80808080808080"
    "80ff80808080808080808080c623eddfc1bba2a0919b3e832dc6ddacb0dc9dfcdd01442f"
    "92d095a7dda2ffdf800195f1ffdde0ffff808080b88deafddedcffc78080805163b5f2b0"
    "bef9caffff800181e8fdd6c5f2c4ffff806379d2fac9c6ffca808080175ba3f2aabbf7d2"
    "ffff8001c8f6ffeaff80808080806db2f1ffe7f5ffff8080802c82c9fdcdc0ffff808080"
    "0184effbdbd1ffa58080805e88e1fbdabeffff8080801664aef5baa1ffc780808001b6f9"
    "ffe8eb80808080807c8ff1ffe3ea8080808080234db5fbc1d3ffcd808080019df7ffece7"
    "ffff808080798debffe1e3ffff8080802d63bcfbc3d9ffe08080800101fbffd5ff808080"
    "8080cb01f8ffff8080808080808901b1ffe0ff8080808080fd09f8fbcfd0ffc0808080af"
    "0de0f3c1b9f9c6ffff804911abdda1b3eca7ffea80015ff7fdd4b7ffff808080ef5af4fa"
    "d3d1ffff8080809b4dc3f8bcc3ffff8080800118effbdadbffcd808080c933dbffc4ba80"
    "80808080452ebeefc9daffe480808001bffbffff808080808080dfa5f9ffd5ff80808080"
    "808d7cf8ffff8080808080800110f8ffff808080808080be24e6ffecff80808080809501"
    "ff808080808080808001e2ff8080808080808080f7c0ff8080808080808080f080ff8080"
    "8080808080800186fcffff808080808080d53efaffff808080808080375dff8080808080"
    "808080808080808080808080808080808080808080808080808080808080808080808080"
    "ca18d5ebbabfdca0f0afff7e26b6e8a9b8e4aeffbb803d2e8adb97b2f0aaffd8800170e6"
    "fac7bff79fffff80a66de4fcd3d7ffae808080274da2e8acb4f5b2ffff800134dcf6c6c7"
    "f9dcffff807c4abff3b7c1faddffff80184782db9aaaf3b6ffff8001b6e1f9dbf0ffe080"
    "80809596e2fcd8cdffab8080801c6caaf2b7c2fedfffff800151e6fccccbffc08080807b"
    "66d1f7bcc4ffe9808080145f99f3a4adffcb80808001def8ffd8d58080808080a8aff6fc"
    "ebcdffff8080802f74d7ffd3d4ffff8080800179ecfdd4d6ffff8080808d54d5fcc9caff"
    "db8080802a50a0f0a2b9ffcd8080800101ff8080808080808080f401ff80808080808080"
    "80ee01ff8080808080808080")
# CoeffsUpdateProba[4][8][3][11].
_UPDATE = bytes.fromhex(
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffb0f6ff"
    "ffffffffffffffffdff1fcfffffffffffffffff9fdfdfffffffffffffffffff4fcffffff"
    "ffffffffffeafefefffffffffffffffffdfffffffffffffffffffffff6feffffffffffff"
    "ffffeffdfefffffffffffffffffefffefffffffffffffffffff8fefffffffffffffffffb"
    "fffefffffffffffffffffffffffffffffffffffffffffdfefffffffffffffffffbfefeff"
    "fffffffffffffffefffefffffffffffffffffffefdfffefffffffffffffafffefffeffff"
    "fffffffffeffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffd9ffffffffffffffffffffe1fcf1fdfffffeffffffffeafa"
    "f1fafdfffdfefffffffffeffffffffffffffffffdffefeffffffffffffffffeefdfefeff"
    "fffffffffffffff8fefffffffffffffffff9feffffffffffffffffffffffffffffffffff"
    "fffffffffdfffffffffffffffffff7feffffffffffffffffffffffffffffffffffffffff"
    "fffdfefffffffffffffffffcfffffffffffffffffffffffffffffffffffffffffffffefe"
    "fffffffffffffffffdfffffffffffffffffffffffffffffffffffffffffffffefdffffff"
    "fffffffffffafffffffffffffffffffffeffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffbafbfaffffffffffffffffea"
    "fbf4fefffffffffffffffbfbf3fdfefffefffffffffffdfeffffffffffffffffecfdfeff"
    "fffffffffffffffbfdfdfefefffffffffffffffefefffffffffffffffffefefeffffffff"
    "fffffffffffffffffffffffffffffffffefffffffffffffffffffefeffffffffffffffff"
    "fffefffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "ffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffffff"
    "f8fffffffffffffffffffffafefcfefffffffffffffff8fef9fdfffffffffffffffffdfd"
    "fffffffffffffffff6fdfdfffffffffffffffffcfefbfefefffffffffffffffefcffffff"
    "fffffffffff8fefdfffffffffffffffffdfffefefffffffffffffffffbfeffffffffffff"
    "fffff5fbfefffffffffffffffffdfdfefffffffffffffffffffbfdfffffffffffffffffc"
    "fdfefffffffffffffffffffefffffffffffffffffffffcfffffffffffffffffff9fffeff"
    "fffffffffffffffffffefffffffffffffffffffffdfffffffffffffffffaffffffffffff"
    "fffffffffffffffffffffffffffffffffffffffffffffffffffffeffffffffffffffffff"
    "ffffffffffffffffffffffff")
# kBModesProba[10][10][9].
_BMODES = bytes.fromhex(
    "e7783059737178987098b3407eaa762e465faf458f505552489b67383a0aabdabd110d98"
    "721a11a32cc3150aad791850c31a3e2c405590470a26abd590221aaa2e371388a021ce47"
    "3f14087272d00c09e251280b60b6541d102486b7598962656aa59448bb64829d6f204b50"
    "4266a7634a3e28ea80293509b2f18d1a086b4a2b1a9249a631179d412669a033341f7380"
    "684f0c1bd9ff5711075744472c72330fba172f290e6eb6b71511c2422d1966c5bd171216"
    "585893962a2e2dc4cd2b61b775552623b33d2735c8571a152be8ab3822336872661d5d4d"
    "271c55ab3aa55a6240221674ce17222ba6496b36201a3301512b1f44196a1640ab24e172"
    "2213156684bc104c7c3e124e5f5539323033c165239fd76f592e6f3c941facdbe415126f"
    "70714d55b3ff267872282a01c4f5d10a196d582b1d8ca6d5252b9a3d3f1e9b432d4401d1"
    "6450082b9a01331a478e4e4e10ff8022c5ab29280566d3b70401dd333211a8d1c0171952"
    "8a1f24ab1ba6262ce543573aa952731a3bb33f3b5ab43ba65d499a282815748fd12227af"
    "2f0f10b722df312db72e1121b706620f20b7392e16188001361125412049731c801780cd"
    "2803097333c01206df572509733b4d40152f68372cda09363582e2405a46cd2829171a39"
    "363970b8052926a6d51e221a8598740a2086271335dd1a722049ff1f0941ea020f017649"
    "4b200c33c0ffa02b33581f2343665537ba553815176f3bcd2d25c03726467c4966012262"
    "7d622a58685575af525f543559806471652d4b4f7b2f338051ab01391105476639352931"
    "26210d7939491a0155290a438a4d6e5a2f727315020a66ffa61706651d100a558065c41a"
    "39120a6666d522142b75140f24a38044011a663d472522351ff3c0453c472649771cde25"
    "442d8022012f0bf5ab3e1113469255373e46252b259a64a355a0013f095c881c4020c955"
    "4b0f090940ffb8771056061c0540ff19f8013808118489ff3774803a0f145287391a7928"
    "a4321f899a851923da33672c83837b1f069e5628408794e02db780161a1183f09a0e01d1"
    "2d10155b40de0701c53815279b3c8a1766d5530c0d36c0ff442f1c551a555580802092ab"
    "120b073f90ab0404f6231b0a92aeab0c1a80be502363b4507e362d557e2f57b033291420"
    "654b808b769274805538290fb0ec5525093e471e117776ff11128a65263c8a37462b1a8e"
    "9224131eabff611b148a2d3d3edb0151bc4020291475978e1415a370130c3dc380300418")
# kCodeToPlane[120].
_CODE_TO_PLANE = bytes.fromhex(
    "1807171928062729161a262a38053739151b363a252b48044749141c353b464a242c5845"
    "4b343c035759131d565a232d444c555b333d68026769121e666a222e545c434d656b323e"
    "78017779535d111f646c424e767a212f757b313f636d525e00747c414f1020626e30737d"
    "515f40727e616f50717f6070")

DC_TABLE = np.frombuffer(_DC, np.uint8).astype(np.int32)
AC_TABLE = np.frombuffer(_AC, "<u2").astype(np.int32)
COEFF_PROBA0 = np.frombuffer(_PROBA0, np.uint8).reshape(4, 8, 3, 11)
COEFF_UPDATE = np.frombuffer(_UPDATE, np.uint8).reshape(4, 8, 3, 11)
BMODES_PROBA = np.frombuffer(_BMODES, np.uint8).reshape(10, 10, 9)
CODE_TO_PLANE = np.frombuffer(_CODE_TO_PLANE, np.uint8)
