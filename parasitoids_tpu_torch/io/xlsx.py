"""Minimal first-party .xlsx reader (L1, host-side).

The reference loads its field-observation workbooks through
``pandas.read_excel`` (Data_Import.py:457,529,590,645), which needs an Excel
engine this environment does not ship.  An .xlsx file is a zip of simple
SpreadsheetML XML, and the observation workbooks only use shared strings,
numbers and date-styled serials — so we read them directly: worksheet XML →
typed columns → ``pandas.DataFrame`` with the same header/NaN semantics
``read_excel`` would produce for these files.
"""

from __future__ import annotations

import re
import zipfile
from xml.etree import ElementTree as ET

import numpy as np
import pandas as pd

_NS = '{http://schemas.openxmlformats.org/spreadsheetml/2006/main}'
_REL_NS = ('{http://schemas.openxmlformats.org/package/2006/relationships}'
           'Relationship')
# builtin Excel date/time number formats
_BUILTIN_DATE_FMTS = set(range(14, 23)) | set(range(45, 48))
_EXCEL_EPOCH = pd.Timestamp('1899-12-30')

__all__ = ['read_sheet', 'sheet_names']


def _shared_strings(z):
    try:
        root = ET.fromstring(z.read('xl/sharedStrings.xml'))
    except KeyError:
        return []
    return [''.join(t.text or '' for t in si.iter(_NS + 't'))
            for si in root]


def _date_styles(z):
    """Set of cellXfs indices that render as dates."""
    try:
        root = ET.fromstring(z.read('xl/styles.xml'))
    except KeyError:
        return set()
    custom = {}
    for fmt in root.iter(_NS + 'numFmt'):
        code = re.sub(r'\[[^\]]*\]|"[^"]*"', '', fmt.get('formatCode', ''))
        custom[int(fmt.get('numFmtId'))] = bool(re.search(r'[dmy]', code,
                                                          re.I))
    date_xfs = set()
    cell_xfs = root.find(_NS + 'cellXfs')
    if cell_xfs is not None:
        for i, xf in enumerate(cell_xfs.findall(_NS + 'xf')):
            fmt_id = int(xf.get('numFmtId', '0'))
            if fmt_id in _BUILTIN_DATE_FMTS or custom.get(fmt_id, False):
                date_xfs.add(i)
    return date_xfs


def _sheet_targets(z):
    """Map sheet name -> worksheet member path inside the archive."""
    wb = ET.fromstring(z.read('xl/workbook.xml'))
    rels = ET.fromstring(z.read('xl/_rels/workbook.xml.rels'))
    rel_target = {r.get('Id'): r.get('Target') for r in rels}
    rid = '{http://schemas.openxmlformats.org/officeDocument/2006/' \
          'relationships}id'
    out = {}
    for sheet in wb.iter(_NS + 'sheet'):
        target = rel_target[sheet.get(rid)]
        if not target.startswith('/'):
            target = 'xl/' + target
        else:
            target = target.lstrip('/')
        out[sheet.get('name')] = target
    return out


def sheet_names(path):
    with zipfile.ZipFile(path) as z:
        return list(_sheet_targets(z))


def _col_index(ref):
    """'BC12' -> zero-based column 54."""
    n = 0
    for ch in ref:
        if ch.isalpha():
            n = n * 26 + (ord(ch.upper()) - 64)
        else:
            break
    return n - 1


def read_sheet(path, sheet_name, header=0):
    """Read one worksheet into a DataFrame (header row semantics of
    ``pandas.read_excel``: row ``header`` gives column names, missing
    header cells become ``Unnamed: <i>``, blank data cells become NaN)."""
    with zipfile.ZipFile(path) as z:
        targets = _sheet_targets(z)
        if sheet_name not in targets:
            raise KeyError('sheet {!r} not in {} (has {})'.format(
                sheet_name, path, list(targets)))
        strings = _shared_strings(z)
        date_xfs = _date_styles(z)
        root = ET.fromstring(z.read(targets[sheet_name]))

    rows = {}
    max_col = -1
    for row in root.iter(_NS + 'row'):
        r = int(row.get('r')) - 1
        cells = {}
        for c in row.iter(_NS + 'c'):
            ref = c.get('r')
            col = _col_index(ref)
            t = c.get('t')
            s = c.get('s')
            v_el = c.find(_NS + 'v')
            if t == 'inlineStr':
                is_el = c.find(_NS + 'is')
                val = ''.join(e.text or '' for e in is_el.iter(_NS + 't')) \
                    if is_el is not None else None
            elif v_el is None or v_el.text is None:
                val = None
            elif t == 's':
                val = strings[int(v_el.text)]
            elif t == 'str':
                val = v_el.text
            elif t == 'b':
                val = bool(int(v_el.text))
            else:
                num = float(v_el.text)
                if s is not None and int(s) in date_xfs:
                    val = _EXCEL_EPOCH + pd.to_timedelta(num, unit='D')
                else:
                    val = num
            if val is not None:
                cells[col] = val
                max_col = max(max_col, col)
        if cells:
            rows[r] = cells

    if not rows:
        return pd.DataFrame()

    ncol = max_col + 1
    # pandas skips blank rows, so the header index counts non-empty rows
    ordered = [rows[r] for r in sorted(rows)]
    header_cells = ordered[header] if header < len(ordered) else {}
    names = [header_cells.get(i, 'Unnamed: {}'.format(i))
             for i in range(ncol)]

    data_rows = ordered[header + 1:]
    columns = {}
    for i, name in enumerate(names):
        # pandas mangles duplicate headers to 'name.1'; a dict would
        # silently drop the earlier column's data
        base, k = name, 1
        while name in columns:
            name = '{}.{}'.format(base, k)
            k += 1
        col = [row.get(i, np.nan) for row in data_rows]
        columns[name] = col
    df = pd.DataFrame(columns)
    # tidy dtypes: all-number object columns -> float/int, timestamps stay
    for name in df.columns:
        series = df[name]
        if series.dtype == object:
            try:
                df[name] = pd.to_numeric(series)
            except (ValueError, TypeError):
                pass
    return df
