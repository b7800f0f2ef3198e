"""Quartz-style cron schedules for ``#window.cron``.

siddhi-core's CronWindowProcessor takes a Quartz cron expression
(6-7 fields: sec min hour day-of-month month day-of-week [year]) and
flushes the collected window at every fire. This module provides the
HOST side of that: parse the expression and map event timestamps to
per-event window indices, which ship to the device as a narrow column
(the device never does calendar math — "an emission schedule, not
device math").

``window_ids`` is a PURE function of the timestamps: a window index is
the absolute number of fires since the epoch (1970-01-01 UTC), computed
from field-set counting plus a lazily-built per-year matching-day table.
No anchor, no data-dependent state — the same timestamp always maps to
the same window id, across micro-batches, jobs, and shards (the
per-year cache is deterministic, so sharing one instance is safe).

Supported field syntax: ``*``, ``?``, lists ``a,b,c``, ranges ``a-b``,
steps ``*/n``, ``a/n`` (= every n from a), ``a-b/n``, month names
JAN..DEC, day names SUN..SAT (Quartz numeric day-of-week 1=SUN..7=SAT;
0 is also accepted as Sunday), and numeric years. ``L``/``W``/``#``
calendar extensions are rejected loudly. All times are UTC.
"""

from __future__ import annotations

import calendar
from dataclasses import dataclass, field
from datetime import datetime, timedelta, timezone
from typing import Dict, Optional

import numpy as np

from ..query.lexer import SiddhiQLError

_MONTHS = {
    n: i + 1
    for i, n in enumerate(
        "JAN FEB MAR APR MAY JUN JUL AUG SEP OCT NOV DEC".split()
    )
}
# Quartz day-of-week numbering: 1 = SUN .. 7 = SAT
_DOW_NAMES = {
    n: i + 1 for i, n in enumerate("SUN MON TUE WED THU FRI SAT".split())
}
_DAY_MS = 86_400_000
_EPOCH_YEAR = 1970


def _parse_field(text: str, lo: int, hi: int, names=None):
    """One cron field -> sorted allowed-value array, or None for */?."""
    text = text.strip().upper()
    if text in ("*", "?"):
        return None
    for bad in ("L", "W", "#"):
        if bad in text:
            raise SiddhiQLError(
                f"#window.cron: calendar extension {bad!r} is not "
                "supported"
            )

    def val(tok: str) -> int:
        if names and tok in names:
            return names[tok]
        try:
            v = int(tok)
        except ValueError:
            raise SiddhiQLError(
                f"#window.cron: bad field value {tok!r}"
            ) from None
        return v

    out = set()
    for part in text.split(","):
        step = 1
        has_step = "/" in part
        if has_step:
            part, s = part.split("/", 1)
            try:
                step = int(s)
            except ValueError:
                raise SiddhiQLError(
                    f"#window.cron: bad step {s!r}"
                ) from None
            if step <= 0:
                raise SiddhiQLError("#window.cron: step must be > 0")
        if part in ("*", "?", ""):
            a, b = lo, hi
        elif "-" in part:
            a_s, b_s = part.split("-", 1)
            a, b = val(a_s), val(b_s)
        else:
            a = val(part)
            # 'a/n' means every n starting at a (even for n == 1)
            b = hi if has_step else a
        if not (lo <= a <= hi and lo <= b <= hi):
            raise SiddhiQLError(
                f"#window.cron: value out of range [{lo},{hi}]: "
                f"{part!r}"
            )
        out.update(range(a, b + 1, step))
    return np.asarray(sorted(out), dtype=np.int64)


@dataclass
class CronSchedule:
    """Parsed Quartz cron expression. ``window_ids`` is pure; the only
    mutable state is a deterministic per-year matching-day cache."""

    expr: str
    sec: Optional[np.ndarray] = None
    minute: Optional[np.ndarray] = None
    hour: Optional[np.ndarray] = None
    dom: Optional[np.ndarray] = None
    month: Optional[np.ndarray] = None
    dow: Optional[np.ndarray] = None  # 0=SUN..6=SAT
    year: Optional[np.ndarray] = None
    # day-ordinal (days since 1970-01-01) -> cumulative matching days
    # strictly before that year's Jan 1 (built lazily, deterministic)
    _year_cum: Dict[int, int] = field(default_factory=dict)
    _day_cache: Dict[int, int] = field(default_factory=dict)

    @classmethod
    def parse(cls, expr: str) -> "CronSchedule":
        fields = expr.split()
        if len(fields) not in (6, 7):
            raise SiddhiQLError(
                "#window.cron expects a Quartz expression with 6-7 "
                f"fields (sec min hour dom month dow [year]); got "
                f"{expr!r}"
            )
        dom_f, dow_f = fields[3].upper(), fields[5].upper()
        if dom_f != "?" and dow_f not in ("?", "*"):
            # Quartz requires one of dom/dow to be '?': AND-ing both
            # is ambiguous — reject loudly instead of guessing
            raise SiddhiQLError(
                "#window.cron: specify day-of-month or day-of-week, "
                "not both (use '?' for the other)"
            )
        # Quartz day-of-week is 1=SUN..7=SAT. A BARE '0' is tolerated
        # as Sunday (common habit), but 0 inside ranges/lists rejects
        # loudly: silently reading '0-6' as unix-style would drop
        # Saturday while Quartz-style reads it as an error — ambiguous
        # either way, so it must not parse.
        dow_text = ",".join(
            "1" if part.strip() == "0" else part
            for part in fields[5].split(",")
        )
        dow_raw = _parse_field(dow_text, 1, 7, _DOW_NAMES)
        dow = None
        if dow_raw is not None:
            dow = np.unique((dow_raw - 1) % 7)
        return cls(
            expr=expr,
            sec=_parse_field(fields[0], 0, 59),
            minute=_parse_field(fields[1], 0, 59),
            hour=_parse_field(fields[2], 0, 23),
            dom=_parse_field(fields[3], 1, 31),
            month=_parse_field(fields[4], 1, 12, _MONTHS),
            dow=dow,
            year=(
                _parse_field(fields[6], 1970, 2099)
                if len(fields) == 7
                else None
            ),
        )

    # -- calendar matching -----------------------------------------------
    def _date_ok(self, y: int, mo: int, d: int) -> bool:
        if self.year is not None and y not in self.year:
            return False
        if self.month is not None and mo not in self.month:
            return False
        if self.dom is not None and d not in self.dom:
            return False
        if self.dow is not None:
            # Python weekday(): Mon=0..Sun=6 -> 0=SUN..6=SAT
            wd = (calendar.weekday(y, mo, d) + 1) % 7
            if wd not in self.dow:
                return False
        return True

    def _days_in_year(self, y: int) -> int:
        n = 0
        months = (
            self.month.tolist()
            if self.month is not None
            else range(1, 13)
        )
        if self.year is not None and y not in self.year:
            return 0
        for mo in months:
            for d in range(1, calendar.monthrange(y, mo)[1] + 1):
                if self._date_ok(y, mo, d):
                    n += 1
        return n

    def _year_cum_before(self, y: int) -> int:
        """Matching days in [1970-01-01, y-01-01)."""
        if y in self._year_cum:
            return self._year_cum[y]
        prev = (
            0
            if y <= _EPOCH_YEAR
            else self._year_cum_before(y - 1) + self._days_in_year(y - 1)
        )
        self._year_cum[y] = prev
        return prev

    def _matching_days_before(self, day_ord: int) -> int:
        """Matching days in [1970-01-01, day_ord)."""
        cached = self._day_cache.get(day_ord)
        if cached is not None:
            return cached
        date = datetime(
            _EPOCH_YEAR, 1, 1, tzinfo=timezone.utc
        ) + timedelta(days=day_ord)
        n = self._year_cum_before(date.year)
        mo = 1
        while mo < date.month:
            for d in range(
                1, calendar.monthrange(date.year, mo)[1] + 1
            ):
                if self._date_ok(date.year, mo, d):
                    n += 1
            mo += 1
        for d in range(1, date.day):
            if self._date_ok(date.year, date.month, d):
                n += 1
        if len(self._day_cache) > 100_000:
            self._day_cache.clear()
        self._day_cache[day_ord] = n
        return n

    # -- fire counting ----------------------------------------------------
    def _sets(self):
        sec = (
            self.sec
            if self.sec is not None
            else np.arange(60, dtype=np.int64)
        )
        minute = (
            self.minute
            if self.minute is not None
            else np.arange(60, dtype=np.int64)
        )
        hour = (
            self.hour
            if self.hour is not None
            else np.arange(24, dtype=np.int64)
        )
        return sec, minute, hour

    def window_ids(self, ts_ms: np.ndarray) -> np.ndarray:
        """Per-event window index = number of fires at-or-before the
        event's timestamp, since the epoch. Pure in ts (modulo the
        deterministic calendar cache); monotone, so sorted tapes ship
        it as small wire deltas after the first batch."""
        ts_ms = np.asarray(ts_ms, dtype=np.int64)
        if ts_ms.size == 0:
            return np.zeros(0, dtype=np.int32)
        sec, minute, hour = self._sets()
        fpd = len(sec) * len(minute) * len(hour)
        day = ts_ms // _DAY_MS
        rem = ts_ms - day * _DAY_MS
        h = rem // 3_600_000
        mi = (rem // 60_000) % 60
        s = (rem // 1000) % 60
        # fires earlier today: full earlier hours + full earlier minutes
        # of this hour + fires at/before this second of this minute
        nh = np.searchsorted(hour, h, side="left")
        nmi = np.searchsorted(minute, mi, side="left")
        ns = np.searchsorted(sec, s, side="right")
        h_ok = hour[np.clip(nh, 0, len(hour) - 1)] == h
        h_ok &= nh < len(hour)
        mi_ok = minute[np.clip(nmi, 0, len(minute) - 1)] == mi
        mi_ok &= nmi < len(minute)
        intra = nh * len(minute) * len(sec) + np.where(
            h_ok, nmi * len(sec) + np.where(mi_ok, ns, 0), 0
        )
        base = np.empty(ts_ms.shape, dtype=np.int64)
        today_ok = np.empty(ts_ms.shape, dtype=bool)
        for d in np.unique(day).tolist():
            seld = day == d
            date = datetime(
                _EPOCH_YEAR, 1, 1, tzinfo=timezone.utc
            ) + timedelta(days=int(d))
            base[seld] = self._matching_days_before(int(d)) * fpd
            today_ok[seld] = self._date_ok(
                date.year, date.month, date.day
            )
        wid = base + np.where(today_ok, intra, 0)
        if wid.size and int(wid.max()) >= 2 ** 31:
            raise SiddhiQLError(
                "#window.cron: window index exceeds int32 (schedule "
                "fires too often for this time range)"
            )
        return wid.astype(np.int32)

    def next_fire(self, after_ms: int) -> Optional[int]:
        """Smallest fire time strictly greater than ``after_ms``
        (diagnostic/test helper; the engine uses window_ids)."""
        t = datetime.fromtimestamp(
            after_ms / 1000.0, tz=timezone.utc
        ).replace(microsecond=0) + timedelta(seconds=1)
        sec, minute, hour = self._sets()
        for _ in range(366 * 8):  # bounded day search (~8 years)
            y, mo, d = t.year, t.month, t.day
            if self.year is not None and y > int(self.year.max()):
                return None
            if not self._date_ok(y, mo, d):
                t = (t + timedelta(days=1)).replace(
                    hour=0, minute=0, second=0
                )
                continue
            for hh in hour.tolist():
                if hh < t.hour:
                    continue
                for mm in minute.tolist():
                    if hh == t.hour and mm < t.minute:
                        continue
                    for ss in sec.tolist():
                        if (
                            hh == t.hour
                            and mm == t.minute
                            and ss < t.second
                        ):
                            continue
                        fire = datetime(
                            y, mo, d, hh, mm, ss, tzinfo=timezone.utc
                        )
                        return int(fire.timestamp() * 1000)
            t = (t + timedelta(days=1)).replace(
                hour=0, minute=0, second=0
            )
        return None
