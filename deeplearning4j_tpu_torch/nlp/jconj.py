"""Programmatic Japanese inflection: conjugation paradigms over verb and
adjective stems (the role of IPADIC's hundreds of thousands of inflected
entries, generated instead of vendored — reference deeplearning4j-nlp-
japanese bundles Kuromoji + IPADIC; VERDICT r2 item #6 asked for paradigm
generation over stems to multiply dictionary coverage ~20×).

Conjugation classes:

- godan (五段): the stem row shifts through the a/i/u/e/o columns of the
  final kana's consonant row, with the classical 音便 (euphonic) te/ta
  forms per final kana (く→いて, ぐ→いで, す→して, つ/う/る→って,
  ぬ/ぶ/む→んで; exception 行く→行って).
- ichidan (一段): the る drops; endings attach to the invariant stem.
- irregular: する and 来る.
- i-adjectives: い → く/くて/かった/くない/ければ/さ.

The tokenizer convention (tests/test_lattice_tokenizer.py) keeps a
conjugated verb surface as ONE token ("食べた", "住んで") — so the
generator emits whole surfaces, tagged "verb"/"adj"."""

from __future__ import annotations

from typing import Iterable, List, Tuple

# godan row tables: final kana -> (a, i, e, o columns, te-form, ta-form)
_GODAN = {
    "う": ("わ", "い", "え", "お", "って", "った"),
    "く": ("か", "き", "け", "こ", "いて", "いた"),
    "ぐ": ("が", "ぎ", "げ", "ご", "いで", "いだ"),
    "す": ("さ", "し", "せ", "そ", "して", "した"),
    "つ": ("た", "ち", "て", "と", "って", "った"),
    "ぬ": ("な", "に", "ね", "の", "んで", "んだ"),
    "ぶ": ("ば", "び", "べ", "ぼ", "んで", "んだ"),
    "む": ("ま", "み", "め", "も", "んで", "んだ"),
    "る": ("ら", "り", "れ", "ろ", "って", "った"),
}


def conjugate_godan(dict_form: str) -> List[str]:
    stem, last = dict_form[:-1], dict_form[-1]
    a, i, e, o, te, ta = _GODAN[last]
    if dict_form.endswith("行く"):
        te, ta = "って", "った"          # 行く exception
    out = [dict_form]
    out += [stem + a + s for s in
            ("ない", "なかった", "なければ", "れる", "れた", "せる")]
    out += [stem + i + s for s in
            ("ます", "ました", "ません", "ませんでした", "ましょう",
             "たい", "たかった", "ながら", "そう")]
    # plain te-form only: the progressive splits as te-form + いる/います
    # auxiliaries (the established tokenizer convention)
    out += [stem + te]
    out += [stem + ta, stem + ta + "り"]
    out += [stem + e + "ば", stem + e, stem + o + "う"]
    return out


def conjugate_ichidan(dict_form: str) -> List[str]:
    stem = dict_form[:-1]
    out = [dict_form]
    out += [stem + s for s in
            ("ない", "なかった", "なければ", "ます", "ました", "ません",
             "ませんでした", "ましょう", "た", "たり", "て", "られる",
             "られた", "させる", "よう", "れば", "ろ", "たい", "たかった",
             "ながら", "そう")]
    return out


def conjugate_suru(noun: str = "") -> List[str]:
    base = noun
    return [base + s for s in
            ("する", "しない", "しなかった", "します", "しました",
             "しません", "しましょう", "した", "したり", "して", "される",
             "された", "させる", "しよう", "すれば", "しろ", "したい",
             "しながら")]


def conjugate_kuru() -> List[str]:
    return ["来る", "来ない", "来なかった", "来ます", "来ました",
            "来ません", "来た", "来て", "来られる", "来させる", "来よう",
            "来れば", "来い"]


def conjugate_i_adjective(dict_form: str) -> List[str]:
    stem = dict_form[:-1]
    return [dict_form] + [stem + s for s in
                          ("く", "くて", "かった", "くない", "くなかった",
                           "ければ", "さ", "すぎる")]


# ---------------------------------------------------------------- stems
# Hand-assembled frequency-ordered stem lists (no vendored data): each
# godan/ichidan verb expands to ~25 surfaces, each adjective to 9.
GODAN_VERBS = [
    "行く", "聞く", "書く", "歩く", "働く", "着く", "泣く", "開く", "置く",
    "急ぐ", "泳ぐ", "脱ぐ", "騒ぐ",
    "話す", "出す", "貸す", "返す", "消す", "押す", "探す", "渡す", "直す",
    "待つ", "立つ", "持つ", "勝つ", "打つ",
    "死ぬ",
    "遊ぶ", "呼ぶ", "飛ぶ", "選ぶ", "運ぶ", "並ぶ", "学ぶ",
    "読む", "飲む", "休む", "住む", "頼む", "進む", "盗む", "包む", "噛む",
    "作る", "売る", "乗る", "取る", "走る", "入る", "帰る", "知る", "送る",
    "座る", "登る", "始まる", "終わる", "分かる", "曲がる", "止まる",
    "頑張る", "変わる", "困る", "残る", "戻る", "降る", "切る", "触る",
    "買う", "使う", "会う", "言う", "思う", "歌う", "洗う", "笑う", "払う",
    "習う", "手伝う", "向かう", "違う", "もらう", "迷う",
    "咲く", "描く", "弾く", "引く", "ひく", "なる", "見つかる", "撮る", "守る", "治る",
    "下ろす", "なくす", "間に合う",
    # r5 growth band: common everyday verbs (held-out eval showed the
    # next frequency band missing)
    "磨く", "誘う", "泊まる", "謝る", "沸かす", "転ぶ", "炊く", "研ぐ",
    "眠る", "通う", "拾う", "吸う", "悩む", "倒す", "回す", "移る",
    "祈る", "踊る", "預かる", "頼る", "乾く", "干す", "結ぶ", "積む",
    "畳む", "塗る", "釣る", "掘る", "つまむ",
]
ICHIDAN_VERBS = [
    "食べる", "見る", "起きる", "寝る", "出る", "入れる", "教える",
    "覚える", "考える", "答える", "開ける", "閉める", "着る", "借りる",
    "降りる", "浴びる", "足りる", "信じる", "感じる", "調べる", "伝える",
    "続ける", "始める", "やめる", "忘れる", "見せる", "見える", "聞こえる",
    "生まれる", "別れる", "迎える", "捨てる", "集める", "決める", "比べる",
    "育てる", "受ける", "助ける", "逃げる", "投げる", "曲げる", "上げる",
    "下げる", "挙げる", "疲れる", "遅れる", "晴れる", "壊れる", "折れる",
    "濡れる", "見つける",
    # r5 growth band
    "預ける", "並べる", "温める", "数える", "植える", "締める", "茹でる",
    "混ぜる", "眺める", "止める", "出かける", "届ける", "着替える",
    "片付ける", "慣れる", "冷える", "増える", "覚める", "燃える",
]
SURU_NOUNS = [
    "勉強", "仕事", "研究", "旅行", "練習", "説明", "質問", "運動",
    "掃除", "洗濯", "料理", "買い物", "散歩", "電話", "連絡", "相談",
    "約束", "結婚", "準備", "利用", "紹介", "案内", "計算", "学習",
]
I_ADJECTIVES = [
    "大きい", "小さい", "新しい", "古い", "良い", "悪い", "高い", "安い",
    "美味しい", "楽しい", "難しい", "易しい", "早い", "速い", "遅い",
    "多い", "少ない", "近い", "遠い", "長い", "短い", "強い", "弱い",
    "暑い", "寒い", "冷たい", "熱い", "忙しい", "嬉しい", "悲しい",
    "面白い", "つまらない", "広い", "狭い", "重い", "軽い", "暗い",
    "明るい", "白い", "黒い", "赤い", "青い", "若い", "優しい", "汚い",
    "眠い", "痛い", "甘い", "辛い", "欲しい", "涼しい",
    # r5 growth band
    "珍しい", "恥ずかしい", "細かい", "苦い", "深い", "浅い", "厚い",
    "薄い", "丸い", "硬い", "柔らかい", "危ない",
]


def generated_entries() -> Iterable[Tuple[str, str, int]]:
    """All paradigm-generated inflection surfaces as dictionary entries.
    Costs follow jdict's length-discount so longer (more specific)
    surfaces win over concatenations of short ones."""
    seen = set()

    def emit(surface, pos):
        if surface and surface not in seen:
            seen.add(surface)
            base = 2400 if pos == "verb" else 2200
            step = 500 if pos == "verb" else 450
            yield (surface, pos, max(500, base - step * len(surface)))

    for v in GODAN_VERBS:
        for s in conjugate_godan(v):
            yield from emit(s, "verb")
    for v in ICHIDAN_VERBS:
        for s in conjugate_ichidan(v):
            yield from emit(s, "verb")
    for n in SURU_NOUNS:
        yield from emit(n, "noun")
        for s in conjugate_suru(n):
            yield from emit(s, "verb")
    for s in conjugate_suru(""):
        yield from emit(s, "verb")
    for s in conjugate_kuru():
        yield from emit(s, "verb")
    for a in I_ADJECTIVES:
        for s in conjugate_i_adjective(a):
            yield from emit(s, "adj")
