"""Bit-exact replica of Go's math/rand generator (the legacy ALFG source).

The reference's rand()/rand_normal()/rand_exponential() transform functions
(transform.go:2653 newTransformRand) draw from rand.New(rand.NewSource(seed))
— Go's additive lagged Fibonacci generator y[n] = y[n-273] + y[n-607] mod
2^64, seeded via a MINSTD LCG chain XORed against the `rngCooked` state
table.  Replicating the stream bit-for-bit makes the seeded rand() golden
cases (exec_test.go) reproducible.

The cooked table below is NOT copied from Go's sources: it is re-derived by
running the documented generation procedure (gen_cooked.go: seed the state
with srand(1), advance 7.8e12 steps, dump the state vector).  The 7.8e12-step
warmup is fast-forwarded analytically — the recurrence is linear over Z_2^64,
so the state after N steps is x^N reduced modulo the characteristic
polynomial x^607 - x^334 - 1 (see `_generate_cooked`, which rebuilds the
table in ~0.1s and is cross-checked by tests against the embedded blob).

Validated against the golden corpus: the seed-0/seed-1 Float64 streams,
ziggurat NormFloat64/ExpFloat64 draws, and multi-hundred-draw subquery cases
all match the reference's expected values.

The port's copy of ``victoriametrics_tpu/query/gorand.py``, whole.
"""

from __future__ import annotations

import base64
import math

import numpy as np

_M31 = (1 << 31) - 1
_M63 = (1 << 63) - 1
_M64 = (1 << 64) - 1

_COOKED_B85 = (
    ">i?MQGfMZxTVIyCK}vhT53hmC6UAN=>y<;NT>At{j?WNx9E0em!@)O?=;U2}sfGVTch4bXVf"
    "mkGRR+sK(%0xf(a0ulp!yLsA5o`CRZylPNq6mWTrKKf#-CiBXhQ)?Ijg-t3pA2xSu^@@0&1q"
    "tPWuq9iqX7_sl1=}tbn5~vCQ|E8!Pk5l-H2~uPoyvG%{*GD-;1AlFUNJXn^xipN1l#AUUrm5"
    "u>rCmYu@A`J@M1h9!Y1JeMkJ;Zl0{+cTtUp2><kZXuL|e3@HO#i@YXY4^+X@AAU~3?cvSG32"
    "$T^;0RCG*ie9>Cq71G8AeqNwLvcnPTL<QF%CaI82#mW3HQ3Vbm24cc9Yg#FoFk^B~%4hGI{!"
    "zn9xa7TS;@dX+L5Jcn^mOOV<bI#4@4D22!JrHJD*cj(X=tP97!a_}4YaA_p~hNw^W6pGRJOm"
    "oz<c=>Lmj;ALvSMe`+rt6#43L7K<FI(v!SxLp(IW0_x^7@rwT{Q2oy(^qn9^#BpIbe$myV5m"
    "OaCQ~%_t^3E3XonMH`IT97%h+<dF$Yhe0w5)n7iu%Vh(vYap59)td4<1K-1b##nxB`nwE0Rl"
    "(@fyy(zQfK~aULM(4V*Ru!|HNpEQR1dyOSX@^jLZ4^)paLHPe|JXIn*i;p&v>2G)pxQHJ{eJ"
    "UJR^YM)t?7~VDL(ky3+rbW@|jXol5!-t>r7r+mqq5fE5kcn6?p3GZs@F6Q(h@f2)nIMnre`X"
    "$zw$JY6wvM{MH%$tc3%upE}XurPSuToCBM;GoK0kHChaWBqDg(&l=T5yf{u5K2F|LpD*}R4)"
    "3#v3i=J<X_rHL?AZzG5l~Fb$HSgc)#DSy51B^`;#<zoe&7c`z9Jd7xX{w2VaI&PAL<@O-PZB"
    "<-d<411?e0Bj@NGcx@h!7HVVww&?!VN+cClv(>;`sn#~;I(ZY`?^=U|EwT~7~U~k3U_WH4~t"
    "K?BZC%LE2=tq|9-eJCd7(%CZJPvqCK#g~R6Xa~dMnrLv3vlNdz*|RU7j4*J9e4;1;BocU=?@"
    "Q|S8j+izhZ7j=Cn>y{|s@ArI|RMrB>)9nizvui+rC{6aWGSoKpyxXH-$L?pge}6sDPki~o=F"
    "B2qm%=PRc5I7mz@gMy1t-uN$Q$Da`O3_rzO@vR)wCRl4g2?cV&`j)&9QgHz3`;*f)HU0z#O8"
    "c(NZkt@j89=_0FvqWp>WO&QnYHi-n^^j|NebQ=@DGE@aZVR6-GyhOfVXh8zGAT>VYj9rB7?="
    "vB)#vEBPO#ZP`7*g&;%cvuN*zlA?dEX3Hk7)3yvI}?R=_6`L<$uo~PLS6hG*^1<%Af#5bS_p"
    "n1hb&=Pr4j)+r07ki&5vY?On+PwlGU9bC5gh$E}r~~ARP^6zSH==$G2=cZ9zXU(aGwnHwK4g"
    "~18Dv}6p4XE7tms&>$RTJUG3iEo|2jSCYAd(=jD@f^XA%GBpFCc!rNSIJmBaKZc6RG;2mQq6"
    "bLZ_b`?c>-uKe3sGbDd)+Yb&jK<ATjlHJCnb077OW~m(dZc9^?K@Ha+MRIDuk_8eOy%x<d+}"
    "11%SZhU%?<s_84ZLDpUODNwsZMlA;jV;Sf)wu<G~#hOw=y0|z$jA0CvWZ#q2$uwJ1$N}2w>r"
    "Y^k=&xCvzm|LA4PN*RLvl4EcSo8aXT!mh|CNbVB+i_6|TD6Q0fxW|jt-+RVY%G+9L=Ad=d*I"
    "YL3^R#hkVk&vIXy^1JgJ!_GIpl=4pq0myFq413RY-TECgRNt*9hjYrN`AIjVWQt--@@$cHvT"
    "-$|7268E9>O8(HD0Oo)^+@+eaccx1w>mJH-&yCC}yCVN!E*ttbzZi|c;`0o|2aTC`YmK(Vbb"
    "gAh!3c1N^-22=;@^ynZP*}%uPKwl@^Cl7n3-S{nYg~)`&uQw*PG4_jtNruT`Sbrxl?jHu<RT"
    "Qi(1tQax>8^O>h6K}kMbXYmA0lTmxMnph1qYZ%xuAZhP*Vb^)0`Ik!hRY;0H-NYusSDK@<X3"
    "-`}gF!NWZw~SJ+z|S@Use7?jo86mUYEt%^}U7=n(>xWhwCx8IU)R=OXUtiUx?#j30akG#t`5"
    "Qwl}bGp84RkcI%)Su@&FrO4-btG{gL*A<POTx>xSEbTSa^7jdb!ogIG=X*u^o;k)pA`~HV%<"
    "FPJ`Fh=1kiKU2I#Fj*^BCF@?p(*J+F&b$(?9_I;j{lHB!F498jk%01~mAj6`i)v@!B#%4TH)"
    "<TtnC=~14z&uE(*REI`z$u}uoqbT1fwXj5Kb+Z18oK7RcLqWnRj|KvbPkH_HedQJ3Xz-8)3B"
    "Zl3t(dLk2BegMg0WRWKXm`pCoo3NMF{L@5hDiEIm5t)NtgkyS`L_2Hke_|8U;PC60)?mdf{w"
    "vO7W_2Ksw%)$;(GIUsmYp*|-8?G_2bl80txiLC#YsxxA-SI&YyyB@?QmVkpT=V`jnDaiEjD&"
    "T9XXQR-}|fHFXOBwA*Hk2@GzWaPlofJ`eQraHP<O+B84W92W)iG!lK<o*(sxD29$y$rKqu#w"
    "iw37@R<__{fWxWv)zvjg8<3GIT*#FQrXVAGq2xdX<~S7t(h_u5#6t1_Nq8{2=#;V*_3)i`<A"
    "0PI;OmR36B*^o;YFUT7OhFsFh>s>pm+clfr&}(+6hZM?#wkBUfQ}%YCKr1|5G}icXis@u@L3"
    "mE;KHUN@cX(1l=zo_$VjU}z)Ee;nDe6v(Dx8(d0yt9;p?u0|*?S~cV@Wn^GP0*!WCwhIduQV"
    "cr9Z~F*he{Vbp5xWdEkuPps^n#cW%kILNm4&CxGVH38^{F-R#O4TWBW~O}CMb(rlcZR5}d~d"
    "HcbU5w;t+z0+rY5#siV4g8kVBI`-8`>cLN)lFsfo0s7o$|zk}r))!AdD$2;hT_-LMHZdUJie"
    "zdu*{x&;itDBg2E};&L1l)4KZY1H;`J`y?r7P7HTug&2ad-^(ARzUU7s=CD7nQN0K3Tb;S+{"
    "aoPJ=59D4K;k>O|Hq3ZEl`@cncA%AnQ#)!o)4++3rij>x9H^UPfu~$|oQ<zPlPH~0KMlm{#C"
    "_k#*fIVA+tz(J1AuJ<mkJ_i_aO$12PX)6%&68`V0A|LDp%?%!}<NmHUW_w;)N3t{@p&u--n~"
    "7qPgvP`}W1$deK(Z$D=4~`3WcYYR-*9@M$eo7Q&L6zO=iXT^#hv_O3Tin5oyz5D`Pu${ozJ<"
    "sE!H*{fb+rxAk$EFP!~v>fDK{J$OLXj?c#|DyTSa35;ZT+6U0xy<Uy<PhLvL9X3D;2z1SQdE"
    "Bq%M6!TR54+GbxZ{i3mk%r2nK}t5zj=#O=~Y;r?)mGfB7b%)rJ={liPBGaLuX7+EFA_2U_RX"
    "1d(MZ4WZ?vujaV;%j+bNBPH{IGkg;WUqW7~7!ji~9xH%AVGCrvUmPp(&^&&Yr@6X+=!p;mK?"
    "pv&v-=zIYttMJt;2si!&$dz+4Qo%0@4LZR&|6-gZegNDhsIK<2r*HXSk(?jpdK)D2QNr7v~{"
    "YpUW!)-WGn`<s{M)mDJ!-f{W%UqX^3gbxOc1C7m)zrZxD5s2S{+_n9Y65bg4Iz^yt&7iZ*m;"
    "(axVY@Ix|t_OLqHCx*R;A_q&*zsH0C<4EmW3%BUd*LyzCAoc-o<iv(C1`#;t6vV4Gg+U%aW?"
    "8IED$m|L+{eE!N`Bd9@2gdM`DijfD&KoLaq_>%}2Kvj)VHC4h8|>g#64~j8LbnWBCL>grKUU"
    "rPJ%^r1werY~Mls-fM><e4ge9PjV!|w5D1;@(oA7xRCXkAT^jNJ!O?x^pMOE(fBB<p$%07+c"
    "X<1T+Bjv0EDcRHk-EyEN=OP3)OPJko5@b_<3-YatH;2A-8O4r`0yB$y<oj;g|k-wTQTE{p18"
    "v5Q3Cq0XMl82zl>3R%H{uCVHp6D5%{O6NZob&s(koxVNGRKru4V9;wLFKI~_>paB4f<=vC8`"
    "N8(&c!LYP>}v>)$NX==mr-?|_yqDa?geKgOePl9f_0L|JQGHBq<i7B;<Tz<8xcRFUL`{m7LG"
    "lloPp3pvncUMO(3f|`y$b7sy2@!zYr;0x|?6%5Uj3{$|~d!u(nj4%gqmZIAo9L2{uOoUm#k<"
    "Ey%dGj_qj2tRwwH4U#4DWO;##TCKe$t6BlM@0`4TJ#*@$kLMmdq#}8B(S;7<A^w5j#XS;XW="
    ">~$5W$Ar`?(sqKbIJZDvWK)RqoUPwY3#eZASprDsAfGvuIHKh07z|5UE`tTX&x}5nh{@*Xm_"
    "`baKcm=bgbSs)M?g)oY;B5QinA=R=bg+55Z#b7E^Gna%Eq0s}lP8!$^Fzw9vyT?t`4m_+1L;"
    "_Cas5Qx$_Zq@jka3_UzGF}4jZL+1tJJ^9cYo}Oq@j4E4H+UfoVUYw{x_fZxPQWy>B*PNVfpp"
    "gB-xS^w2dKe41>|L71<gj5BjR2Dg<I{(0Lm1VFy=JCz3DaTsj*z8OwSk;tX)`x`W@$bw&uUa"
    "m=%PTfNI|D(+FXvbbv>U!~rHrDEstDxUA=8njRl)U!$YoAo9aRehn6^mnTBR6)de0TGhU(jj"
    "U4MEWW)d4Es11&~8YgSWu#m-5=?DP|p}4O34Oo<w>^ux$+sl0_X4D&=8|-aA@a$8P>F&W9x*"
    "}ZRx0?7Fqa${XKx9MoeVaL<$-@VyaTLix?#u5xpSB7^^<|nd%VTPEXP^Y|J)gB{^+4=%Fk7o"
    "^^g;abRqGJ-Z%~FKLF42y42QdD8ys>MFgmtPrd7-ogyGE8DiPgc2MplK;J1+r-q@9weZkkbz"
    "r2uFqh8MfQ0ckscV7j4@oG)#Ed;ai)MYRj0c9UX^)u*RaOW_Q`iALo8<Y!XXbTyqktaytIbG"
    "Nz!h}v1Z~u#X<?_jz^XS8?NRqi(%7mcj{d}ItK_puW@c2&_{R<{;K=LuYn)UK*@Lq#&NzRA("
    "m<c-?qXX&ukBslTMV-2SB491ZT(M#&%^O$@v>nQC@M^D|%~&K{k1eJaw0P<Yh{D8LZk;>-Te"
    "f3lY-?w<*NDKPPLZ3RHDk$Sp7y-sDyaaMM7@|69=f15=0Ah$Z8t2JOD9I%;G1CS{6sI3VWe+"
    "IqeL3iQNV$G)`5!@-{l&S`qwWUAW=JcU2`w$(X~Ww=Pbh06!?h|Dum1ms3%R*dw4k`WO;FDv"
    "Kf)iXnTU9ID8UgJc+3i#_gEH{=Z`aMrFPbt%c)c^^m$QR(#2bZ(YH}X~r3DG>$LtS9y$9m!V"
    "8APoPZxF!9zF;bQ1E{-+eO0CsJeZkjQDgkniL&e|B8`X$!#+;jr&bYsj2Mz65L);gcmicdL<"
    "_;Ovt3<|w;riGV)nlkWt{M%yC`aL@h~sR2X^$=t(}K7c#s61nQ+^cm&FmLql$GEL&tQQIWlh"
    "%Kum2@(3h=;#hO!6!&!;)bru>QB!iw|^>}TJt@rO^<<Idd9ZSjO5+a>HAGSApMm++4Yw7N*t"
    "#+&W(PC?o*<Jb1cH43xrg)+{XUNDI<*S03euee%jS<2$fNT>$wsv#+FW#D>Owgy8e&=^huoR"
    "zdp-1hD1g$+wF)|&K<mH}B3O(~frR(&%CfRdypszZ4GMcmI52kLI=3!%IPc$Fn%SpgQ+`b(0"
    "15{q?pi=k5AO%5v;+Y$--NU%$pg<>Cmuy7)rB3_=rsuCme^_p<q=bWe6D(BTTploc5Bv`*^o"
    "m^yFh>P~dBA-L!a2s%wkw)&sC-5W-Zt8_Yr8_?b_2;CQ?Pkp_d^)mn9qy_!LAXo7ql0I8)V("
    "^Pu<?^GU!PoD2F$U`{?Huh`aFB^upK=NKm$gZ3}i!bE-vs6bRB&g+gLk#OG)kpeqhQ0ATl{x"
    "fy;33<G3gk5v~PpT*|DNHKMJL)bg-^3r#jZ{Y!ljks=RXoe^>&gXJf2iB2Pv4V~3RKDvPr)9"
    "!-2cAA}-Q7n?hE;i7WB!d|oB2P~IX-71BK3^NZ3up2W}JSXX5%;RIOwmWN4wXOy|?1q->aS<"
    "(ZRLyYRXSCDH~f-QlaEo4s>;m3ek~#*p<qEI#Ybi+p&go_xolNy~EK)x@MYa8gR8Fv2oT*O~"
    "9_63jISYRb}Di7cmrABdkagyTw?8#R}tqy?6GikALu_CvutmP~otgUCc<RL7U{T9&rj}csa@"
    ")puhZNgvV?DFRKceUgkooP-k2@^z)ULOzM9qibD2D7d94^lp&v)lGS&~_+OLu*=AA1sT@O(q"
    "677(>=3?D!=uwt>6R!KfZ%!cBq$(TIO(<J492ioN*=oV2ePUuSY_U*E;x(FjRfA|*WY@~mRe"
    "JEJMdm}o1s^J#wEZpItrjU"
)

_cooked: list[int] | None = None


def _cooked_table() -> list[int]:
    global _cooked
    if _cooked is None:
        raw = base64.b85decode(_COOKED_B85)
        _cooked = [int(v) for v in np.frombuffer(raw, dtype=np.uint64)]
    return _cooked


def _seedrand(x: int) -> int:
    """MINSTD step with Schrage's trick (rng.go seedrand): a=48271, m=2^31-1."""
    hi, lo = divmod(x, 44488)
    x = 48271 * lo - 3399 * hi
    return x + _M31 if x < 0 else x


def _generate_cooked(n_steps: int = 7_800_000_000_000) -> np.ndarray:
    """Re-derive rngCooked: gen_cooked.go seeds the 607-slot state with
    srand(1) (20/10/0-bit LCG packing) and runs the ALFG for 7.8e12 steps;
    the table is the resulting state vector.  The warmup is jumped via
    square-and-multiply of x^N mod (x^607 - x^334 - 1) with uint64
    coefficient wraparound."""
    # srand(1): gen_cooked.go's packing uses shifts 20/10/0
    x = 1
    vec = np.zeros(607, dtype=np.uint64)
    with np.errstate(over="ignore"):
        for i in range(-20, 607):
            x = _seedrand(x)
            if i >= 0:
                u = x << 20
                x = _seedrand(x)
                u ^= x << 10
                x = _seedrand(x)
                u ^= x
                vec[i] = np.uint64(u)

        def polymul_mod(a, b):
            c = np.zeros(1213, dtype=np.uint64)
            for i in range(607):
                if a[i]:
                    c[i:i + 607] += a[i] * b
            for d in range(1212, 606, -1):
                if c[d]:
                    c[d - 273] += c[d]
                    c[d - 607] += c[d]
                    c[d] = np.uint64(0)
            return c[:607].copy()

        result = np.zeros(607, dtype=np.uint64)
        result[0] = 1
        base = np.zeros(607, dtype=np.uint64)
        base[1] = 1
        n = n_steps
        while n:
            if n & 1:
                result = polymul_mod(result, base)
            n >>= 1
            if n:
                base = polymul_mod(base, base)

        # base sequence z_m = y_{m-606}; initial slot consumption order puts
        # y_{-606+m} at vec[(333 - m) % 607]
        z = np.array([vec[(333 - m) % 607] for m in range(607)],
                     dtype=np.uint64)
        g = result  # x^N mod f -> z_N = y_{N-606}
        ys = {}
        for j in range(607):
            ys[n_steps - 606 + j] = int((g * z).sum()) & _M64
            c = g[606]
            g = np.roll(g, 1)
            g[0] = np.uint64(0)
            g[334] += c
            g[0] += c
        # state slot s was last written at the largest step k <= N with
        # k == (334 - s) mod 607
        out = np.zeros(607, dtype=np.uint64)
        for s in range(607):
            r = (334 - s) % 607
            out[s] = np.uint64(ys[n_steps - ((n_steps - r) % 607)])
    return out


# -- ziggurat tables (normal.go / exp.go, float32 like Go's) ----------------

def _norm_tables():
    f32 = np.float32
    kn = [0] * 128
    wn = [f32(0)] * 128
    fn = [f32(0)] * 128
    m1 = 1 << 31
    dn = tn = 3.442619855899
    vn = 9.91256303526217e-3
    q = vn / math.exp(-0.5 * dn * dn)
    kn[0] = int((dn / q) * m1) & 0xFFFFFFFF
    kn[1] = 0
    wn[0] = f32(q / m1)
    wn[127] = f32(dn / m1)
    fn[0] = f32(1.0)
    fn[127] = f32(math.exp(-0.5 * dn * dn))
    for i in range(126, 0, -1):
        dn = math.sqrt(-2.0 * math.log(vn / dn + math.exp(-0.5 * dn * dn)))
        kn[i + 1] = int((dn / tn) * m1) & 0xFFFFFFFF
        tn = dn
        fn[i] = f32(math.exp(-0.5 * dn * dn))
        wn[i] = f32(dn / m1)
    return kn, wn, fn


def _exp_tables():
    f32 = np.float32
    ke = [0] * 256
    we = [f32(0)] * 256
    fe = [f32(0)] * 256
    m2 = 1 << 32
    de = te = 7.697117470131487
    ve = 3.949659822581572e-3
    q = ve / math.exp(-de)
    ke[0] = int((de / q) * m2) & 0xFFFFFFFF
    ke[1] = 0
    we[0] = f32(q / m2)
    we[255] = f32(de / m2)
    fe[0] = f32(1.0)
    fe[255] = f32(math.exp(-de))
    for i in range(254, 0, -1):
        de = -math.log(ve / de + math.exp(-de))
        ke[i + 1] = int((de / te) * m2) & 0xFFFFFFFF
        te = de
        fe[i] = f32(math.exp(-de))
        we[i] = f32(de / m2)
    return ke, we, fe


_NORM = None
_EXP = None


class GoRand:
    """rand.New(rand.NewSource(seed)) equivalent: Int63/Uint32/Float64 plus
    the ziggurat NormFloat64/ExpFloat64."""

    def __init__(self, seed: int):
        cooked = _cooked_table()
        seed %= _M31
        if seed < 0:
            seed += _M31
        if seed == 0:
            seed = 89482311
        x = seed
        vec = [0] * 607
        for i in range(-20, 607):
            x = _seedrand(x)
            if i >= 0:
                u = (x << 40) & _M64
                x = _seedrand(x)
                u ^= x << 20
                x = _seedrand(x)
                u ^= x
                u ^= cooked[i]
                vec[i] = u & _M64
        self.vec = vec
        self.tap = 0
        self.feed = 607 - 273

    def int63(self) -> int:
        self.tap = (self.tap - 1) % 607
        self.feed = (self.feed - 1) % 607
        v = (self.vec[self.feed] + self.vec[self.tap]) & _M64
        self.vec[self.feed] = v
        return v & _M63

    def uint32(self) -> int:
        return self.int63() >> 31

    def float64(self) -> float:
        while True:
            f = self.int63() / (1 << 63)
            if f != 1.0:
                return f

    def norm_float64(self) -> float:
        global _NORM
        if _NORM is None:
            _NORM = _norm_tables()
        kn, wn, fn = _NORM
        f32 = np.float32
        rn = 3.442619855899
        while True:
            u = self.uint32()
            j = u - (1 << 32) if u >= (1 << 31) else u  # int32 view
            i = j & 0x7F
            x = float(j) * float(wn[i])
            if abs(j) < kn[i]:
                return x
            if i == 0:
                while True:
                    x = -math.log(self.float64()) * (1.0 / rn)
                    y = -math.log(self.float64())
                    if y + y >= x * x:
                        break
                x += rn
                return x if j > 0 else -x
            if f32(float(fn[i]) + self.float64() *
                   (float(fn[i - 1]) - float(fn[i]))) <                     f32(math.exp(-0.5 * x * x)):
                return x

    def exp_float64(self) -> float:
        global _EXP
        if _EXP is None:
            _EXP = _exp_tables()
        ke, we, fe = _EXP
        f32 = np.float32
        re = 7.69711747013104972
        while True:
            j = self.uint32()
            i = j & 0xFF
            x = float(j) * float(we[i])
            if j < ke[i]:
                return x
            if i == 0:
                return re - math.log(self.float64())
            if f32(float(fe[i]) + self.float64() *
                   (float(fe[i - 1]) - float(fe[i]))) < f32(math.exp(-x)):
                return x
