"""Static phoneme data tables for the rule-based English IPA phonemizer.

The port's own copy of `tts_tpu/text/phoneme_data.py`.  Parity tables with
the reference's src/models/kokoro/phonemizer.h:19-291
(character classes, small-word lists, letter/number/symbol phonemes, roman
numerals, contractions).  These are linguistic data, not code.
"""

ALPHABET = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"
ACCENTED_A = "àãâäáåÀÃÂÄÁÅ"
ACCENTED_C = "çÇ"
ACCENTED_E = "èêëéÈÊËÉ"
ACCENTED_I = "ìîïíÌÎÏÍ"
ACCENTED_N = "ñÑ"
ACCENTED_O = "òõôöóøÒÕÔÖÓØ"
ACCENTED_U = "ùûüúÙÛÜÚ"
COMMON_ACCENTED_CHARACTERS = (
    ACCENTED_A + ACCENTED_C + ACCENTED_E + ACCENTED_I + ACCENTED_N + ACCENTED_O + ACCENTED_U
)
WORD_CHARACTERS = ALPHABET + "." + COMMON_ACCENTED_CHARACTERS
NON_CLAUSE_WORD_CHARACTERS = ALPHABET + COMMON_ACCENTED_CHARACTERS + "'"
VOWELS = "aeiouy"

ACCENT_FOLD = {}
for chars, plain in [(ACCENTED_A, "a"), (ACCENTED_C, "c"), (ACCENTED_E, "e"),
                     (ACCENTED_I, "i"), (ACCENTED_N, "n"), (ACCENTED_O, "o"),
                     (ACCENTED_U, "u")]:
    for ch in chars:
        ACCENT_FOLD[ch] = plain

ONE_LETTER_WORDS = {"a", "i"}

TWO_LETTER_WORDS = {
    "ab", "ah", "am", "an", "as", "at", "aw", "ax", "ay", "be", "bo", "br",
    "by", "do", "eh", "er", "ew", "ex", "go", "ha", "he", "hi", "hm", "ho",
    "id", "if", "in", "is", "it", "la", "lo", "ma", "me", "mm", "my", "na",
    "no", "of", "oh", "oi", "on", "oo", "or", "ow", "ox", "oy", "pa", "qi",
    "re", "sh", "so", "to", "uh", "um", "un", "up", "us", "we", "wo", "ya",
    "ye", "yo",
}

THREE_LETTER_WORDS = {
    "aah", "abs", "aby", "ace", "ach", "ack", "act", "add", "ado", "ads", "aft", "age",
    "ago", "aha", "ahi", "aid", "ail", "aim", "air", "alb", "ale", "all", "alp", "alt",
    "ama", "amp", "and", "ant", "any", "ape", "app", "apt", "arc", "are", "arf", "ark",
    "arm", "art", "ash", "ask", "asp", "ass", "ate", "awe", "axe", "aye", "baa", "bad",
    "bae", "bag", "bah", "bam", "ban", "bao", "bap", "bar", "bat", "bay", "bed", "bee",
    "beg", "bet", "bez", "bib", "bid", "big", "bin", "bio", "bis", "bit", "biz", "boa",
    "bod", "bog", "boi", "boo", "bop", "bot", "bow", "box", "boy", "bra", "bro", "brr",
    "bub", "bud", "bug", "bum", "bun", "bur", "bus", "but", "buy", "bye", "cab", "caf",
    "cam", "can", "cap", "car", "cat", "caw", "chi", "cig", "cis", "cly", "cob", "cod",
    "cog", "col", "con", "coo", "cop", "cos", "cot", "cow", "cox", "coy", "cry", "cub",
    "cue", "cum", "cup", "cur", "cut", "cuz", "dab", "dad", "dag", "dal", "dam", "dap",
    "das", "daw", "day", "deb", "def", "del", "den", "dep", "dew", "dib", "did", "die",
    "dif", "dig", "dim", "din", "dip", "dis", "div", "doc", "doe", "dog", "doh", "dom",
    "don", "dos", "dot", "dox", "dry", "dub", "dud", "due", "dug", "duh", "dum", "dun",
    "duo", "dup", "dur", "dye", "ear", "eat", "ebb", "eco", "eek", "eel", "egg", "ego",
    "elf", "elk", "elm", "emo", "emu", "end", "eon", "era", "err", "est", "eve", "eww",
    "eye", "fab", "fad", "fae", "fag", "fah", "fam", "fan", "fap", "far", "fat", "fav",
    "fax", "fay", "fed", "fee", "feh", "fem", "fen", "few", "fey", "fez", "fib", "fid",
    "fig", "fin", "fir", "fit", "fix", "flu", "fly", "fob", "foe", "fog", "foo", "fop",
    "for", "fox", "fro", "fry", "fub", "fun", "fur", "gab", "gad", "gag", "gal", "gam",
    "gap", "gas", "gay", "gee", "gel", "gem", "gen", "geo", "get", "gib", "gid", "gif",
    "gig", "gin", "gip", "git", "goa", "gob", "god", "goo", "gor", "got", "gov", "grr",
    "gum", "gun", "gup", "gut", "guy", "gym", "gyp", "had", "hag", "hah", "haj", "ham",
    "hap", "has", "hat", "haw", "hay", "heh", "hem", "hen", "her", "hes", "hew", "hex",
    "hey", "hic", "hid", "him", "hip", "his", "hit", "hmm", "hod", "hoe", "hog", "hop",
    "hot", "how", "hoy", "hub", "hue", "hug", "huh", "hum", "hun", "hup", "hut", "ice",
    "ich", "ick", "icy", "ids", "ifs", "ill", "imp", "ink", "inn", "int", "ion", "ire",
    "irk", "ism", "its", "ivy", "jab", "jam", "jap", "jar", "jaw", "jay", "jet", "jib",
    "jig", "jin", "job", "joe", "jog", "jot", "joy", "jug", "jut", "kat", "kaw", "kay",
    "ked", "keg", "key", "kid", "kin", "kit", "kob", "koi", "lab", "lac", "lad", "lag",
    "lam", "lap", "law", "lax", "lay", "led", "leg", "lei", "lek", "let", "lev", "lex",
    "lib", "lid", "lie", "lip", "lit", "lob", "log", "loo", "lop", "lot", "low", "lug",
    "luv", "lye", "mac", "mad", "mag", "mam", "man", "map", "mar", "mat", "maw", "max",
    "may", "med", "meg", "meh", "mel", "men", "met", "mew", "mib", "mid", "mig", "mil",
    "mix", "mmm", "mob", "mod", "mog", "mol", "mom", "mon", "moo", "mop", "mow", "mud",
    "mug", "mum", "mut", "nab", "nag", "nah", "nan", "nap", "nat", "naw", "nay", "nef",
    "neg", "net", "new", "nib", "nil", "nip", "nit", "nob", "nod", "nog", "noh", "nom",
    "non", "noo", "nor", "not", "now", "noy", "nth", "nub", "nun", "nut", "nyx", "oaf",
    "oak", "oar", "oat", "oba", "obs", "oca", "odd", "ode", "off", "oft", "ohm", "oil",
    "oke", "old", "one", "oof", "ooh", "oom", "oop", "ops", "opt", "orb", "orc", "ore",
    "org", "ort", "oud", "our", "out", "ova", "owe", "owl", "own", "oxy", "pad", "pah",
    "pal", "pan", "par", "pas", "pat", "paw", "pax", "pay", "pea", "pec", "pee", "peg",
    "pen", "pep", "per", "pes", "pet", "pew", "phi", "pho", "pht", "pic", "pie", "pig",
    "pin", "pip", "pit", "pix", "ply", "pod", "poi", "pol", "poo", "pop", "pos", "pot",
    "pow", "pox", "pre", "pro", "pry", "psi", "pst", "pub", "pug", "puh", "pul", "pun",
    "pup", "pur", "pus", "put", "pwn", "pya", "pyx", "qat", "rad", "rag", "rai", "raj",
    "ram", "ran", "rap", "rat", "raw", "ray", "reb", "rec", "red", "ref", "reg", "rem",
    "res", "ret", "rex", "rez", "rho", "ria", "rib", "rid", "rig", "rim", "rin", "rip",
    "rob", "roc", "rod", "roe", "rom", "rot", "row", "rub", "rue", "rug", "rum", "run",
    "rut", "rya", "rye", "sac", "sad", "sag", "sal", "sap", "sat", "saw", "sax", "say",
    "sea", "sec", "see", "seg", "sen", "set", "sew", "sex", "she", "shh", "shy", "sib",
    "sic", "sig", "sim", "sin", "sip", "sir", "sis", "sit", "six", "ska", "ski", "sky",
    "sly", "sob", "sod", "sol", "som", "son", "sop", "sot", "sou", "sow", "sox", "soy",
    "spa", "spy", "sty", "sub", "sue", "sum", "sun", "sup", "sus", "tab", "tad", "tag",
    "tai", "taj", "tan", "tao", "tap", "tar", "tat", "tau", "tav", "taw", "tax", "tea",
    "tec", "tee", "teg", "tel", "ten", "tet", "tex", "the", "tho", "thy", "tic", "tie",
    "til", "tin", "tip", "tis", "tit", "tod", "toe", "ton", "too", "top", "tor", "tot",
    "tow", "toy", "try", "tsk", "tub", "tug", "tui", "tum", "tun", "tup", "tut", "tux",
    "two", "ugh", "umm", "ump", "uni", "ups", "urd", "urn", "use", "uta", "ute", "utu",
    "uwu", "vac", "van", "var", "vas", "vat", "vav", "vax", "vee", "veg", "vet", "vex",
    "via", "vid", "vie", "vig", "vim", "vol", "vow", "vox", "vug", "wad", "wag", "wan",
    "wap", "war", "was", "wat", "wax", "way", "web", "wed", "wee", "wen", "wet", "wey",
    "who", "why", "wig", "win", "wit", "wiz", "woe", "wok", "won", "woo", "wop", "wow",
    "wry", "wud", "wus", "yag", "yah", "yak", "yam", "yap", "yar", "yaw", "yay", "yea",
    "yeh", "yen", "yep", "yes", "yet", "yew", "yin", "yip", "yok", "you", "yow", "yum",
    "yup", "zag", "zap", "zax", "zed", "zee", "zen", "zig", "zip", "zit", "zoo", "zzz",
}

SMALL_ENGLISH_WORDS = ONE_LETTER_WORDS | TWO_LETTER_WORDS | THREE_LETTER_WORDS

LETTER_PHONEMES = {
    "a": "ˈeɪ", "b": "bˈiː", "c": "sˈiː", "d": "dˈiː", "e": "ˈiː", "f": "ˈɛf",
    "g": "dʒˈiː", "h": "ˈeɪtʃ", "i": "ˈaɪ", "j": "dʒˈeɪ", "k": "kˈeɪ",
    "l": "ˈɛl", "m": "ˈɛm", "n": "ˈɛn", "o": "ˈoʊ", "p": "pˈiː", "q": "kjˈuː",
    "r": "ˈɑːɹ", "s": "ˈɛs", "t": "tˈiː", "u": "jˈuː", "v": "vˈiː",
    "w": "dˈʌbəljˌuː", "x": "ˈɛks", "y": "wˈaɪ", "z": "zˈiː",
}
# note: the reference table (phonemizer.h:124-151) has no 'g' entry (a dup 'j'
# key shadows it) — we supply the correct letter phoneme for g.

SPACE_CHARACTERS = " \t\f\n"
NOOP_BREAKS = "{}[]():;,\""
CLAUSE_BREAKS = ".!?"

TRILLION_PHONEME = "tɹˈɪliən"
TRILLION = 1_000_000_000_000
BILLION_PHONEME = "bˈɪliən"
BILLION = 1_000_000_000
MILLION_PHONEME = "mˈɪliən"
MILLION = 1_000_000
POINT_PHONEME = "pˈɔɪnt"
THOUSAND_PHONEME = "θˈaʊzənd"
HUNDRED_PHONEME = "hˈʌndɹɪd"
NUMBER_CHARACTERS = "0123456789"
COMPATIBLE_NUMERICS = NUMBER_CHARACTERS + "., "
LARGEST_PRONOUNCABLE_NUMBER = 999_999_999_999_999

NUMBER_PHONEMES = [
    "zˈiəɹoʊ", "wˈʌn", "tˈuː", "θɹˈiː", "fˈɔːɹ", "fˈaɪv", "sˈɪks", "sˈɛvən",
    "ˈeɪt", "nˈaɪn", "tˈɛn", "ɪlˈɛvən", "twˈɛlv", "θˈɜːtiːn", "fˈɔːɹtiːn",
    "fˈɪftiːn", "sˈɪkstiːn", "sˈɛvəntˌiːn", "ˈeɪtiːn", "nˈaɪntiːn",
]

SUB_HUNDRED_NUMBERS = [
    "twˈɛnti", "θˈɜːɾi", "fˈɔːɹɾi", "fˈɪfti", "sˈɪksti", "sˈɛvənti", "ˈeɪɾi", "nˈaɪnti",
]

REPLACEABLE = {
    "*": "ˈæstɚɹˌɪsk", "+": "plˈʌs", "&": "ˈænd", "%": "pɚsˈɛnt", "@": "ˈæt",
    "#": "hˈæʃ", "$": "dˈɑːlɚ", "~": "tˈɪldə", "¢": "sˈɛnts", "£": "pˈaʊnd",
    "¥": "jˈɛn", "₨": "ɹˈuːpiː", "€": "jˈʊɹɹoʊz", "₹": "ɹˈuːpiː", "♯": "ʃˈɑːɹp",
    "♭": "flˈæt", "≈": "ɐpɹˈɑːksɪmətli", "≠": "nˈɑːt ˈiːkwəl tʊ",
    "≤": "lˈɛs ɔːɹ ˈiːkwəl tʊ", "≥": "ɡɹˈeɪɾɚɹ ɔːɹ ˈiːkwəl tʊ",
    ">": "ɡɹˈeɪɾɚ ðɐn", "<": "lˈɛs ðɐn", "=": "ˈiːkwəlz", "±": "plˈʌs ɔːɹ mˈaɪnəs",
    "×": "tˈaɪmz", "÷": "dᵻvˈaɪdᵻd bˈaɪ", "℞": "pɹɪskɹˈɪpʃən", "№": "nˈuːməˌoʊ",
    "°": "dᵻɡɹˈiːz", "∴": "ðˈɛɹfɔːɹ", "∵": "bɪkˈʌz", "√": "skwˈɛɹ ɹˈuːt",
    "∛": "kjˈuːb ɹˈuːt", "∑": "sˈʌm sˈaɪn", "∂": "dˈɛltə", "←": "lˈɛft ˈæɹoʊ",
    "↑": "ˈʌp ˈæɹoʊ", "→": "ɹˈaɪt ˈæɹoʊ", "↓": "dˈaʊn ˈæɹoʊ", "−": "mˈaɪnəs",
    "¶": "pˈæɹəɡɹˌæf", "§": "sˈɛkʃən",
}

ROMAN_NUMERAL_CHARACTERS = "MDCLXVImdclxvi"
ROMAN_NUMERALS = {
    "m": 1000, "mm": 2000, "mmm": 3000, "c": 100, "cc": 200, "ccc": 300,
    "cd": 400, "cm": 900, "dc": 600, "dcc": 700, "dccc": 800, "x": 10,
    "xx": 20, "xxx": 30, "xl": 40, "l": 50, "lx": 60, "lxx": 70, "lxxx": 80,
    "xc": 90, "i": 1, "ii": 2, "iii": 3, "iv": 4, "v": 5, "vi": 6, "vii": 7,
    "viii": 8, "ix": 9,
}

CONTRACTION_PHONEMES = {"re": "r", "ve": "əv", "ll": "l", "d": "d", "t": "t"}

STOPPING_TOKENS = ".,:;!?"
