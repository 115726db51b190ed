"""SQLite chat/message persistence for the web UI.

The port's own copy of llamafile_tpu/server/db.py (pure Python): llamafile's
db layer (llamafile/schema.sql, db.cpp; the --db flag), the same schema,
stdlib sqlite3 with a connection per thread.
"""
from __future__ import annotations

import os
import sqlite3
import threading
from typing import List, Optional

SCHEMA = """
CREATE TABLE IF NOT EXISTS metadata (
    key TEXT PRIMARY KEY,
    value TEXT
);
CREATE TABLE IF NOT EXISTS chats (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    created_at TIMESTAMP DEFAULT CURRENT_TIMESTAMP,
    model TEXT,
    title TEXT
);
CREATE TABLE IF NOT EXISTS messages (
    id INTEGER PRIMARY KEY AUTOINCREMENT,
    created_at TIMESTAMP DEFAULT CURRENT_TIMESTAMP,
    chat_id INTEGER,
    role TEXT,
    content TEXT,
    temperature REAL,
    top_p REAL,
    presence_penalty REAL,
    frequency_penalty REAL,
    FOREIGN KEY (chat_id) REFERENCES chats(id)
);
"""

SCHEMA_VERSION = 1


class Db:
    def __init__(self, path: str, startup_sql: Optional[str] = None):
        self.path = path
        self._local = threading.local()
        conn = self.conn()
        conn.executescript(SCHEMA)
        conn.execute(
            "INSERT OR IGNORE INTO metadata (key, value) VALUES ('version', ?)",
            (str(SCHEMA_VERSION),))
        if startup_sql and os.path.exists(startup_sql):
            conn.executescript(open(startup_sql).read())
        conn.commit()

    def conn(self) -> sqlite3.Connection:
        c = getattr(self._local, "conn", None)
        if c is None:
            c = sqlite3.connect(self.path)
            c.row_factory = sqlite3.Row
            c.execute("PRAGMA journal_mode=WAL")
            self._local.conn = c
        return c

    # -- chats --------------------------------------------------------------

    def create_chat(self, model: str, title: str = "") -> int:
        c = self.conn()
        cur = c.execute("INSERT INTO chats (model, title) VALUES (?, ?)",
                        (model, title))
        c.commit()
        return cur.lastrowid

    def list_chats(self, limit: int = 100) -> List[dict]:
        rows = self.conn().execute(
            "SELECT * FROM chats ORDER BY id DESC LIMIT ?", (limit,)).fetchall()
        return [dict(r) for r in rows]

    def get_chat(self, chat_id: int) -> Optional[dict]:
        r = self.conn().execute("SELECT * FROM chats WHERE id=?",
                                (chat_id,)).fetchone()
        return dict(r) if r else None

    def set_title(self, chat_id: int, title: str) -> None:
        c = self.conn()
        c.execute("UPDATE chats SET title=? WHERE id=?", (title, chat_id))
        c.commit()

    def delete_chat(self, chat_id: int) -> None:
        c = self.conn()
        c.execute("DELETE FROM messages WHERE chat_id=?", (chat_id,))
        c.execute("DELETE FROM chats WHERE id=?", (chat_id,))
        c.commit()

    # -- messages -----------------------------------------------------------

    def add_message(self, chat_id: int, role: str, content: str,
                    temperature: float = 0.0, top_p: float = 1.0,
                    presence_penalty: float = 0.0,
                    frequency_penalty: float = 0.0) -> int:
        c = self.conn()
        cur = c.execute(
            "INSERT INTO messages (chat_id, role, content, temperature, top_p,"
            " presence_penalty, frequency_penalty) VALUES (?,?,?,?,?,?,?)",
            (chat_id, role, content, temperature, top_p, presence_penalty,
             frequency_penalty))
        c.commit()
        return cur.lastrowid

    def list_messages(self, chat_id: int) -> List[dict]:
        rows = self.conn().execute(
            "SELECT * FROM messages WHERE chat_id=? ORDER BY id",
            (chat_id,)).fetchall()
        return [dict(r) for r in rows]
