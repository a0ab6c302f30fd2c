"""Vocabulary: symbol <-> integer id mapping.

Behavioral parity target: ``unicore/data/dictionary.py:12-148`` (the four
``[CLS]/[PAD]/[SEP]/[UNK]`` specials at ids 0-3, text-file persistence with
an ``#overwrite`` escape hatch for duplicate rows, unk fallback on lookup,
vectorized array lookup).  Independent implementation: ids are stored as a
single ``{symbol: id}`` map plus parallel symbol/count columns, and
``vec_index`` goes through a cached numpy sorted-key table instead of a
per-element Python call, which is what tokenizing whole sequences actually
needs on the hot data path.
"""

import logging

import numpy as np

logger = logging.getLogger(__name__)

_DEFAULT_SPECIALS = ("[CLS]", "[PAD]", "[SEP]", "[UNK]")


class Dictionary:
    """Maps symbols to consecutive integer ids, lowest id first."""

    def __init__(self, *, bos="[CLS]", pad="[PAD]", eos="[SEP]", unk="[UNK]",
                 extra_special_symbols=None):
        self.bos_word = bos
        self.pad_word = pad
        self.eos_word = eos
        self.unk_word = unk
        self._sym2id = {}
        self._id2sym = []
        self._counts = []
        self.specials = set()
        self._vec_cache = None
        for word in (bos, pad, eos, unk):
            self.add_symbol(word, is_special=True)
        for word in extra_special_symbols or ():
            self.add_symbol(word, is_special=True)
        self.bos_index = self._sym2id[bos]
        self.pad_index = self._sym2id[pad]
        self.eos_index = self._sym2id[eos]
        self.unk_index = self._sym2id[unk]

    # -- core mapping --------------------------------------------------

    def add_symbol(self, word, n=1, overwrite=False, is_special=False):
        """Register ``word`` (or bump its count); returns its id.

        ``overwrite=True`` assigns a fresh id even if the symbol exists —
        the contract behind the ``#overwrite`` file flag.
        """
        if is_special:
            self.specials.add(word)
        existing = self._sym2id.get(word)
        if existing is not None and not overwrite:
            self._counts[existing] += n
            return existing
        new_id = len(self._id2sym)
        self._sym2id[word] = new_id
        self._id2sym.append(word)
        self._counts.append(n)
        self._vec_cache = None
        return new_id

    def index(self, sym):
        """Id of ``sym``; unknown symbols resolve to the unk id."""
        assert isinstance(sym, str)
        hit = self._sym2id.get(sym)
        if hit is not None:
            return hit
        unk = self._sym2id.get(self.unk_word)
        if unk is None:
            raise KeyError(f"'{sym}' is out of vocabulary and no unk symbol exists")
        return unk

    def vec_index(self, a):
        """Vectorized ``index`` over an array of symbol strings.

        Uses a sorted-symbol ``np.searchsorted`` table (rebuilt only when
        the vocab changes) — O(len(a) * log V) in numpy instead of one
        Python dict probe per element.  Built from ``_sym2id`` (the
        authoritative map): after ``add_symbol(.., overwrite=True)`` the
        old row lingers in ``_id2sym``, and a table built from it could
        resolve the symbol to its stale id.
        """
        if self._vec_cache is None:
            syms = np.asarray(list(self._sym2id.keys()))
            ids = np.asarray(list(self._sym2id.values()), dtype=np.int64)
            order = np.argsort(syms)
            self._vec_cache = (syms[order], ids[order])
        sorted_syms, ids = self._vec_cache
        a = np.asarray(a)
        pos = np.searchsorted(sorted_syms, a)
        pos = np.clip(pos, 0, len(sorted_syms) - 1)
        found = sorted_syms[pos] == a
        return np.where(found, ids[pos], self.index(self.unk_word))

    def special_index(self):
        """Ids of every registered special symbol."""
        return [self.index(s) for s in self.specials]

    # -- container protocol --------------------------------------------

    def __len__(self):
        return len(self._id2sym)

    def __contains__(self, sym):
        return sym in self._sym2id

    def __getitem__(self, idx):
        return self._id2sym[idx] if idx < len(self._id2sym) else self.unk_word

    def __eq__(self, other):
        return isinstance(other, Dictionary) and self._sym2id == other._sym2id

    # -- well-known ids ------------------------------------------------

    def bos(self):
        return self.index(self.bos_word)

    def pad(self):
        return self.index(self.pad_word)

    def eos(self):
        return self.index(self.eos_word)

    def unk(self):
        return self.index(self.unk_word)

    # -- persistence ---------------------------------------------------
    #
    # File format, one symbol per line (the constructor's default specials
    # are implicit and not written):
    #
    #     <symbol> <count>
    #     <symbol> <count> #overwrite     <- claim a fresh id on collision
    #

    @classmethod
    def load(cls, f):
        """Build a dictionary from a saved vocab file (path or handle)."""
        d = cls()
        d.add_from_file(f)
        return d

    def add_from_file(self, f):
        """Merge symbols from a vocab file into this dictionary."""
        if isinstance(f, str):
            try:
                with open(f, "r", encoding="utf-8") as handle:
                    self.add_from_file(handle)
            except UnicodeError:
                raise Exception(
                    f"vocab file {f} is not valid utf-8; rebuild the dataset"
                )
            return
        rows = f.readlines()
        for lineno, row in enumerate(rows):
            row = row.rstrip()
            overwrite = row.endswith(" #overwrite")
            if overwrite:
                row = row[: -len(" #overwrite")]
            word, sep, count_field = row.rpartition(" ")
            if not sep:
                # bare-symbol row: synthesize a descending count so earlier
                # rows rank higher, like the reference's positional default
                word, count_field = row, str(len(rows) - lineno)
            try:
                count = int(count_field)
            except ValueError:
                raise ValueError(
                    f"bad vocab row {lineno + 1}: expected '<symbol> <count> "
                    f"[#overwrite]', got {row!r}"
                )
            if word in self and not overwrite:
                logger.info(
                    "duplicate vocab symbol %r (line %d) skipped; append "
                    "#overwrite to the row to force a new id", word, lineno + 1
                )
            else:
                self.add_symbol(word, n=count, overwrite=overwrite)

    def save(self, f):
        """Write the vocab file (skipping the implicit default specials)."""
        if isinstance(f, str):
            with open(f, "w", encoding="utf-8") as handle:
                return self.save(handle)
        implicit = {self.bos_word, self.pad_word, self.eos_word, self.unk_word}
        for word, count in zip(self._id2sym, self._counts):
            if word not in implicit:
                f.write(f"{word} {count}\n")

    # -- legacy attribute views (callers/tests that peek at internals) --

    @property
    def symbols(self):
        return self._id2sym

    @property
    def count(self):
        return self._counts

    @property
    def indices(self):
        return self._sym2id
