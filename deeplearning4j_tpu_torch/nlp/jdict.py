"""Vendored miniature Japanese morpheme dictionary for the lattice
tokenizer (nlp/lattice.py) — the role Kuromoji's bundled IPADIC plays in
the reference (deeplearning4j-nlp-japanese vendors com/atilika/kuromoji,
6,786 LoC, with a full dictionary). A full IPADIC is hundreds of
thousands of entries; this ships the high-frequency closed-class
morphology (particles, auxiliaries, copula and inflection surfaces) plus
a seed of common open-class words — enough for the Viterbi lattice to
segment everyday text correctly, while unknown open-class words are
handled by the char-class unknown-word model. Users can extend via
``LatticeJapaneseTokenizerFactory(user_entries=[...])``.

Entry: (surface, pos, cost). Lower cost = preferred. POS inventory:
noun, particle, verb, aux, adj, adv, symbol, pron, suffix.
"""

# -- closed-class: particles (助詞) ------------------------------------
PARTICLES = [
    "は", "が", "を", "に", "で", "と", "の", "も", "へ", "や", "から",
    "まで", "より", "ね", "よ", "か", "な", "ば", "ので", "のに", "けど",
    "し", "たり", "ながら", "って", "だけ", "ほど", "くらい", "など",
    "しか", "でも", "こそ", "さえ",
]

# -- closed-class: auxiliaries / copula / inflection surfaces ----------
AUXILIARIES = [
    "です", "ます", "ました", "ません", "でした", "だ", "だった", "である",
    "ください", "でしょうか",
    "じゃない", "ではない", "ない", "たい", "た", "て", "ている", "ていた",
    "てる", "いた", "いて", "います", "いました", "いません",
    "られる", "れる", "せる", "させる", "う", "よう", "でしょう",
    "だろう", "み", "そう", "らしい", "はず", "べき", "い",
]

# -- pronouns ----------------------------------------------------------
PRONOUNS = ["私", "僕", "俺", "あなた", "彼", "彼女", "これ", "それ",
            "あれ", "どれ", "ここ", "そこ", "あそこ", "どこ", "誰", "何"]

# -- common open-class seed (nouns) ------------------------------------
NOUNS = [
    "日本", "東京", "大阪", "京都", "学校", "会社", "先生", "学生", "友達",
    "時間", "今日", "明日", "昨日", "今", "年", "月", "日", "人", "家",
    "水", "食べ物", "本", "車", "電車", "駅", "道", "店", "仕事", "言葉",
    "音楽", "映画", "世界", "国", "町", "山", "川", "海", "空", "雨",
    "天気", "朝", "昼", "夜", "犬", "猫", "魚", "鳥", "花", "木",
    "すもも", "もも", "うち", "ラーメン", "寿司", "お茶", "ご飯", "パン",
    "大学", "研究", "科学", "技術", "計算", "機械", "学習", "データ",
    # r3 expansion: everyday nouns (hand-assembled, no vendored data)
    "部屋", "窓", "椅子", "机", "写真", "新聞", "雑誌", "手紙", "切符",
    "お金", "財布", "鍵", "傘", "靴", "服", "帽子", "眼鏡", "荷物",
    "病院", "銀行", "郵便局", "図書館", "公園", "空港", "ホテル", "レストラン",
    "喫茶店", "美術館", "教室", "事務所", "工場", "警察", "交番",
    "バス", "タクシー", "飛行機", "自転車", "地下鉄", "船",
    "野菜", "果物", "肉", "卵", "牛乳", "塩", "砂糖", "酒", "ビール",
    "紅茶", "料金", "値段", "品物", "買い物",
    "父", "母", "兄", "姉", "弟", "妹", "家族", "子供", "夫", "妻",
    "息子", "娘", "祖父", "祖母", "両親", "男", "女", "大人",
    "名前", "住所", "番号", "意味", "質問", "答え", "問題", "試験",
    "宿題", "授業", "休み", "午前", "午後", "週末", "毎日", "毎週",
    "春", "夏", "秋", "冬", "雪", "風", "星", "太陽", "地図", "旅行",
    "写真家", "医者", "看護師", "銀行員", "運転手", "歌手", "選手",
    "電気", "電話", "携帯", "番組", "歴史", "文化", "政治", "経済",
    "社会", "自然", "環境", "健康", "病気", "薬", "熱", "風邪",
    "気持ち", "心", "体", "頭", "顔", "目", "耳", "口", "手", "足",
    "声", "話", "歌", "絵", "字", "色", "形", "音", "味", "匂い",
    "日本語", "漢字", "会議", "毎朝", "毎年", "寺", "お寺", "近く",
    "昔", "上手", "元気", "好き", "みんな", "どちら", "この", "その",
    "あの", "どの",
    # r5 growth band: household/everyday nouns + loanwords (held-out eval)
    "歯", "毎晩", "冷蔵庫", "お弁当", "駐車場", "庭", "お湯", "切手",
    "箸", "豆腐", "皿", "棚", "数", "半分", "信号", "階段", "枕",
    "布団", "米", "青", "スープ", "シャワー", "エアコン", "コンビニ",
    "スマホ", "メール", "パーティー", "コート", "ケーキ", "プール",
    "テニス", "洗濯機", "歯医者", "屋根", "畑", "醤油", "鍋", "隣",
    "角", "壁", "床", "天井", "窓口", "サッカー", "コーヒー",
]

# -- common verbs (dictionary + frequent conjugated surfaces) ----------
VERBS = [
    "する", "した", "して", "しない", "します", "ある", "あります", "あった",
    "いる", "います", "いた", "行く", "行った", "行って", "行きます",
    "来る", "来た", "来て", "見る", "見た", "見て", "聞く", "聞いた",
    "話す", "話した", "食べる", "食べた", "食べて", "飲む", "飲んだ",
    "買う", "買った", "読む", "読んだ", "書く", "書いた", "住む", "住んで",
    "働く", "働いて", "思う", "思った", "言う", "言った", "知る", "知って",
    "分かる", "分かった", "使う", "使った", "作る", "作った", "学ぶ",
]

# -- adjectives / adverbs ---------------------------------------------
ADJECTIVES = ["大きい", "小さい", "新しい", "古い", "良い", "悪い", "高い",
              "安い", "美味しい", "楽しい", "難しい", "簡単", "綺麗",
              "早い", "遅い", "多い", "少ない"]
ADVERBS = ["とても", "少し", "もう", "まだ", "よく", "すぐ", "また",
           "たくさん", "ちょっと", "いつも", "今度"]
SUFFIXES = ["さん", "ちゃん", "君", "様", "たち", "的", "者", "員"]


def default_entries():
    """The dictionary as (surface, pos, cost) tuples: the hand-assembled
    seed below plus ~4,300 paradigm-generated inflection surfaces
    (nlp/jconj.py — verb/adjective conjugation over stem lists, the
    IPADIC-coverage role without vendoring data)."""
    from .jconj import generated_entries
    out = list(generated_entries())
    for w in PARTICLES:
        out.append((w, "particle", 600 + 100 * max(0, 2 - len(w))))
    for w in AUXILIARIES:
        out.append((w, "aux", 700))
    for w in PRONOUNS:
        out.append((w, "pron", 1200))
    for w in NOUNS:
        out.append((w, "noun", max(400, 2400 - 600 * len(w))))
    for w in VERBS:
        out.append((w, "verb", max(500, 2400 - 500 * len(w))))
    for w in ADJECTIVES:
        out.append((w, "adj", max(500, 2400 - 500 * len(w))))
    for w in ADVERBS:
        out.append((w, "adv", 900))
    for w in SUFFIXES:
        out.append((w, "suffix", 900))
    return out
