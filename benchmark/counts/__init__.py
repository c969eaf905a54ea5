"""Operations and bytes of the work each call needs, from shapes alone,
and the peaks they are held against."""
