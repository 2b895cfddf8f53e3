"""Bundled mini-treebank: hand-tagged English sentences for training and
evaluating the averaged-perceptron POS tagger (nlp/postagger.py).

The reference ships trained OpenNLP model binaries for its UIMA PoStagger
(en-pos-maxent.bin); vendoring model data is out of scope here, so — like
the generated ja/ko dictionaries (nlp/jconj.py, nlp/kconj.py) — the data
is produced in-repo: a small Penn-style-tagged corpus, split into TRAIN
and HELDOUT so tagger accuracy is reported on sentences the trainer never
saw. Tags are the subset the shallow constituency parser consumes
(nlp/treeparser.py _NOUNISH/_ADJISH/_VERBISH plus DT/IN/CC/RB/TO/PRP$).
"""

from __future__ import annotations

from typing import List, Tuple

TaggedSentence = List[Tuple[str, str]]


def _parse(block: str) -> List[TaggedSentence]:
    out = []
    for line in block.strip().splitlines():
        line = line.strip()
        if not line:
            continue
        sent = []
        for pair in line.split():
            word, tag = pair.rsplit("/", 1)
            sent.append((word, tag))
        out.append(sent)
    return out


TRAIN: List[TaggedSentence] = _parse("""
the/DT dog/NN runs/VBZ in/IN the/DT park/NN
a/DT small/JJ cat/NN sleeps/VBZ on/IN the/DT warm/JJ floor/NN
she/PRP quickly/RB opened/VBD the/DT old/JJ door/NN
they/PRP will/MD visit/VB the/DT museum/NN tomorrow/RB
I/PRP have/VBP seen/VBN that/DT movie/NN twice/RB
the/DT children/NNS are/VBP playing/VBG with/IN their/PRP$ toys/NNS
he/PRP bought/VBD three/CD red/JJ apples/NNS at/IN the/DT market/NN
we/PRP should/MD finish/VB our/PRP$ work/NN before/IN dinner/NN
the/DT tall/JJ man/NN walked/VBD slowly/RB across/IN the/DT street/NN
birds/NNS fly/VBP over/IN the/DT blue/JJ lake/NN
my/PRP$ sister/NN writes/VBZ long/JJ letters/NNS to/TO her/PRP$ friends/NNS
the/DT teacher/NN explained/VBD the/DT difficult/JJ lesson/NN clearly/RB
it/PRP was/VBD raining/VBG heavily/RB last/JJ night/NN
you/PRP can/MD find/VB good/JJ books/NNS in/IN this/DT library/NN
the/DT old/JJ clock/NN on/IN the/DT wall/NN stopped/VBD yesterday/RB
John/NNP and/CC Mary/NNP are/VBP cooking/VBG dinner/NN tonight/RB
the/DT students/NNS have/VBP finished/VBN their/PRP$ exams/NNS
a/DT loud/JJ noise/NN woke/VBD the/DT sleeping/VBG baby/NN
he/PRP never/RB eats/VBZ meat/NN or/CC fish/NN
the/DT company/NN hired/VBD five/CD new/JJ workers/NNS
we/PRP went/VBD to/TO the/DT beach/NN by/IN car/NN
she/PRP is/VBZ reading/VBG an/DT interesting/JJ story/NN
the/DT farmer/NN grows/VBZ corn/NN and/CC wheat/NN
those/DT two/CD houses/NNS were/VBD built/VBN in/IN 1990/CD
I/PRP usually/RB drink/VBP coffee/NN in/IN the/DT morning/NN
the/DT happy/JJ children/NNS sang/VBD a/DT beautiful/JJ song/NN
strong/JJ winds/NNS damaged/VBD the/DT small/JJ boats/NNS
you/PRP must/MD wash/VB your/PRP$ hands/NNS before/IN lunch/NN
the/DT train/NN from/IN London/NNP arrived/VBD late/RB
her/PRP$ brother/NN plays/VBZ football/NN every/DT weekend/NN
a/DT bright/JJ light/NN appeared/VBD in/IN the/DT dark/JJ sky/NN
the/DT cook/NN cut/VBD the/DT onions/NNS with/IN a/DT sharp/JJ knife/NN
they/PRP have/VBP lived/VBN here/RB for/IN ten/CD years/NNS
this/DT new/JJ phone/NN works/VBZ very/RB well/RB
the/DT cat/NN chased/VBD a/DT gray/JJ mouse/NN under/IN the/DT table/NN
we/PRP are/VBP waiting/VBG for/IN the/DT next/JJ bus/NN
snow/NN fell/VBD softly/RB on/IN the/DT quiet/JJ village/NN
the/DT doctor/NN gave/VBD him/PRP some/DT strong/JJ medicine/NN
she/PRP wants/VBZ to/TO learn/VB the/DT piano/NN
old/JJ friends/NNS often/RB share/VBP good/JJ memories/NNS
the/DT workers/NNS repaired/VBD the/DT broken/JJ bridge/NN
a/DT big/JJ ship/NN sailed/VBD across/IN the/DT ocean/NN
he/PRP speaks/VBZ French/NNP and/CC Spanish/NNP
the/DT garden/NN looks/VBZ beautiful/JJ in/IN spring/NN
I/PRP will/MD call/VB you/PRP after/IN the/DT meeting/NN
the/DT little/JJ girl/NN drew/VBD a/DT picture/NN of/IN her/PRP$ family/NN
heavy/JJ rain/NN flooded/VBD the/DT narrow/JJ streets/NNS
they/PRP quickly/RB climbed/VBD the/DT steep/JJ hill/NN
the/DT museum/NN opens/VBZ at/IN nine/CD every/DT day/NN
our/PRP$ team/NN won/VBD the/DT final/JJ game/NN
a/DT gentle/JJ breeze/NN moved/VBD the/DT green/JJ leaves/NNS
the/DT baker/NN sells/VBZ fresh/JJ bread/NN every/DT morning/NN
you/PRP should/MD never/RB leave/VB the/DT door/NN open/JJ
the/DT river/NN flows/VBZ slowly/RB through/IN the/DT valley/NN
Sarah/NNP teaches/VBZ music/NN at/IN the/DT local/JJ school/NN
these/DT flowers/NNS need/VBP water/NN and/CC sunlight/NN
the/DT police/NN found/VBD the/DT stolen/JJ car/NN quickly/RB
he/PRP finished/VBD his/PRP$ homework/NN before/IN the/DT game/NN
a/DT strange/JJ sound/NN came/VBD from/IN the/DT basement/NN
the/DT guests/NNS enjoyed/VBD the/DT delicious/JJ meal/NN
she/PRP carefully/RB placed/VBD the/DT glass/NN on/IN the/DT shelf/NN
winter/NN brings/VBZ cold/JJ weather/NN and/CC short/JJ days/NNS
the/DT boy/NN kicked/VBD the/DT ball/NN over/IN the/DT fence/NN
we/PRP watched/VBD the/DT sunset/NN from/IN the/DT balcony/NN
the/DT engineer/NN designed/VBD a/DT modern/JJ bridge/NN
my/PRP$ parents/NNS travel/VBP to/TO Italy/NNP every/DT summer/NN
the/DT lazy/JJ dog/NN slept/VBD under/IN the/DT big/JJ tree/NN
loud/JJ music/NN filled/VBD the/DT crowded/JJ room/NN
he/PRP carries/VBZ a/DT heavy/JJ bag/NN to/TO work/NN
the/DT children/NNS built/VBD a/DT castle/NN of/IN sand/NN
a/DT kind/JJ woman/NN helped/VBD the/DT lost/JJ tourist/NN
the/DT sun/NN rises/VBZ early/RB in/IN summer/NN
""")

HELDOUT: List[TaggedSentence] = _parse("""
the/DT quick/JJ fox/NN jumped/VBD over/IN the/DT lazy/JJ dog/NN
she/PRP will/MD send/VB the/DT letter/NN tomorrow/RB
my/PRP$ brother/NN cooks/VBZ delicious/JJ pasta/NN every/DT Friday/NNP
the/DT workers/NNS are/VBP building/VBG a/DT new/JJ school/NN
I/PRP have/VBP read/VBN this/DT book/NN twice/RB
a/DT cold/JJ wind/NN blew/VBD from/IN the/DT north/NN
the/DT students/NNS asked/VBD many/JJ difficult/JJ questions/NNS
he/PRP never/RB drinks/VBZ coffee/NN at/IN night/NN
the/DT old/JJ bridge/NN crosses/VBZ the/DT wide/JJ river/NN
they/PRP should/MD clean/VB their/PRP$ rooms/NNS today/RB
the/DT girl/NN smiled/VBD and/CC waved/VBD at/IN us/PRP
two/CD birds/NNS sat/VBD on/IN the/DT high/JJ wire/NN
the/DT chef/NN added/VBD salt/NN and/CC pepper/NN
we/PRP walked/VBD home/RB through/IN the/DT quiet/JJ park/NN
the/DT small/JJ shop/NN sells/VBZ fresh/JJ fruit/NN
Anna/NNP plays/VBZ tennis/NN with/IN her/PRP$ friends/NNS
""")
